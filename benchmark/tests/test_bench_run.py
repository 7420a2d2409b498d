"""The run path's edges on the CPU: no card, no program beside the
benchmark, a forbidden module, and the shape of the last line."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run


def call(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sim_track.static_fleet", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_fails_with_no_result():
    out = call(run.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = call(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_cell_fails():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "no.such_cell", "--seed", "1", "--seconds", "1"],
                         cwd=run.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "multi_purpose_mpc_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "multi_purpose_mpc_tpu.ops", sys)
    assert run.forbidden_modules() == ["multi_purpose_mpc_tpu"]


def test_last_line_shape():
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123, "busy_s": 0.5, "window_s": 0.6}
    out = run.result(True, 4096, 0,
                     {"setup_s": {"value": 20.5, "unit": "s"}}, device,
                     {"device_ops": [["k", 0.1]], "idle_gaps": [["h", 0.01]]},
                     {"pose_gap": (1e-6, 1e-4)})
    line = json.loads(json.dumps(out, allow_nan=False))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["checks"]["pose_gap"] == {"value": 1e-6, "limit": 1e-4}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"}
    assert "breakdown" not in run.result(False, 1, 0, {}, device, None, {})
