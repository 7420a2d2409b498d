"""Frozen operation and byte counts of the hand kernels, one module a
kernel: formulas over a launch's shapes and the solver's fixed budget,
frozen from the plain twins' ``count_ops`` / ``nbytes`` (the arithmetic
each kernel repeats operation for operation) and tied to them by
``benchmark/tests/test_bench_counts.py``.  The run path never calls a twin,
so a count reads the same work whatever implements it."""
