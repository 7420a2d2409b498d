"""Per-layer metrics, one reader a metric: ``metrics/<name>.py`` holds
``read(ctx) -> float | None``, found by the metric's name in
``BENCHMARK.json`` and run in the cells its ``workloads`` list.  ``ctx``
(:class:`benchmark.run.Context`) holds the traced calls' device trace, the
measured window's log counts and host-clock spans, the first call's
capture seconds and the cell's shapes.  A reader that finds nothing to
read returns None and the metric is left out of the line."""
