"""The port's examples run end to end on the CPU: each new example as a
subprocess at a few lanes for a few steps (``--device cpu``)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_fleet_monte_carlo_checkpoints_and_resumes(tmp_path):
    script = os.path.join(REPO, "examples", "torch_fleet_monte_carlo.py")
    ck = str(tmp_path / "fleet.npz")
    args = [script, "--device", "cpu", "--batch", "4", "--steps", "2",
            "--checkpoint", ck, "--out", str(tmp_path / "traj.png")]
    out = _run(args, tmp_path)
    assert "qp_solve_rate" in out and os.path.getsize(tmp_path / "traj.png") > 1000
    with np.load(ck) as d:
        assert int(d["__step__"]) == 2
    out = _run(args + ["--resume"], tmp_path)
    assert "[resume] from step 2" in out
    with np.load(ck) as d:
        assert int(d["__step__"]) == 4


@pytest.mark.parametrize("script,args", [
    ("torch_weight_sweep.py", ["--repeats", "1", "--steps", "2"]),
    ("torch_lidar_mapping_fleet.py", ["--batch", "4", "--steps", "2",
                                      "--shared", "--sharded"]),
])
def test_example_runs(tmp_path, script, args):
    out = _run([os.path.join(REPO, "examples", script), "--device", "cpu",
                *args], tmp_path)
    assert "[best]" in out or "cells discovered" in out
