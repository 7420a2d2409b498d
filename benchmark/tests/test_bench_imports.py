"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "multi_purpose_mpc_tpu"}
HERE = run.HERE


def imports_of(path):
    """Top-level and ``benchmark.*`` module names a file imports."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def closure(start):
    """Every module name reachable from the files ``start`` through the
    benchmark's own modules."""
    seen, todo, names = set(), list(start), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imports_of(path):
            names.add(name)
            if name.split(".")[0] == "benchmark":
                rel = os.path.join(run.ROOT, *name.split("."))
                for cand in (rel + ".py", os.path.join(rel, "__init__.py")):
                    if os.path.exists(cand):
                        todo.append(cand)
    return names


def py_files(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".py")]


def test_run_path_imports_no_jax():
    files = [os.path.join(HERE, "run.py")] + py_files(HERE) \
        + py_files(os.path.join(HERE, "metrics")) \
        + py_files(os.path.join(HERE, "counts")) \
        + py_files(os.path.join(HERE, "kinds")) \
        + py_files(os.path.join(HERE, "reference"))
    tops = {n.split(".")[0] for n in closure(files)}
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = closure(py_files(os.path.join(HERE, "reference")))
    tops = {n.split(".")[0] for n in names}
    assert not tops & (FORBIDDEN | {"multi_purpose_mpc_tpu_torch", "chip_smoke",
                                    "tests", "tools"})


def test_loaded_modules_hold_no_jax():
    """Importing the whole run path, the port included, loads no JAX."""
    code = ("import sys; sys.path.insert(0, {root!r});"
            "import benchmark.run, benchmark.drivers, benchmark.checks,"
            " benchmark.kinds.fleet, benchmark.kinds.lidar_fleet,"
            " benchmark.kinds.api_loop,"
            " benchmark.scenario, benchmark.trace;"
            "import multi_purpose_mpc_tpu_torch, multi_purpose_mpc_tpu_torch.api,"
            " multi_purpose_mpc_tpu_torch.simulation;"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", code.format(root=run.ROOT)],
                         capture_output=True, text=True, check=True,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
