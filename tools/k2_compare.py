"""Kernel K2 against an earlier version of its source, on the card.

    python tools/k2_compare.py OLD_SOURCE [--reps 200]

Builds ``OLD_SOURCE`` (a ``corridor_select.cu`` with the same C interface,
e.g. the one-thread-per-lane design of the port's first K2, unpacked from
an earlier commit) with the package's nvcc flags into a temporary
directory, and the package's own ``csrc/corridor_select.cu`` as usual.
On the Sim_Track horizon blocks of 4096 feasible starts (chip_smoke.py's
seed) it checks both bitwise against the plain version, then times the two
in turns (old, new, new, old; each time the mean of its two) at B = 1,
128, 1024 and 4096 with chip_smoke.device_ms (device time, the host's
per-call overhead excluded) and prints one line per batch with the bound
and the card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from multi_purpose_mpc_tpu_torch.config import sim_track_preset  # noqa: E402
from multi_purpose_mpc_tpu_torch.mpc import mpc_locate  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops import corridor_cuda  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.horizon_table import (  # noqa: E402
    gather_horizon_block)
from multi_purpose_mpc_tpu_torch.ops.path import build_reference_path  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.speed_profile import (  # noqa: E402
    compute_speed_profile)
from multi_purpose_mpc_tpu_torch.simulation import (  # noqa: E402
    feasible_starts, init_fleet, static_horizon_table)
from multi_purpose_mpc_tpu_torch.utils import kernels  # noqa: E402
from multi_purpose_mpc_tpu_torch.utils.maps import (  # noqa: E402
    add_obstacles_host, load_grid_map)


def bind(fn):
    """A launcher ``(blk, S, sm) -> (ub, lb, border_ub, border_lb)`` around
    a ``corridor_select_launch`` C function of a K2 library."""
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(blk, S, sm):
        Bsz, N, F = blk.shape
        ub = torch.empty((Bsz, N), dtype=torch.float32, device=blk.device)
        lb = torch.empty_like(ub)
        cub = torch.empty((Bsz, N, 2), dtype=torch.float32, device=blk.device)
        clb = torch.empty_like(cub)
        rc = fn(blk.data_ptr(), ub.data_ptr(), lb.data_ptr(), cub.data_ptr(),
                clb.data_ptr(), Bsz, N, S, F, float(sm),
                torch.cuda.current_stream(blk.device).cuda_stream)
        kernels.check_launch(rc, "corridor_select_kernel")
        return ub, lb, cub, clb

    return launch


def load_old(source: str, build_dir: str):
    """The launcher of ``source`` built with the package's flags."""
    lib = os.path.join(build_dir, "libcorridor_select_old.so")
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    return bind(ctypes.CDLL(lib).corridor_select_launch)


def sim_track_blocks(dev):
    """``(blk, S, safety_margin)``: the Sim_Track horizon blocks of
    chip_smoke.py's 4096 feasible starts, on ``dev``."""
    map_cfg, path_cfg, model, cfg, speed_cfg, obstacles = sim_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg, device=dev)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)
    table = static_horizon_table(grid, path, cfg, model)
    wp0, ey0 = feasible_starts(grid, path, cfg, model, chip_smoke.B,
                               np.random.default_rng(chip_smoke.SEED))
    fleet = init_fleet(path, cfg.N, chip_smoke.B, e_y0=ey0, wp_id0=wp0)
    blk = gather_horizon_block(table, mpc_locate(fleet, path)[0])
    return blk, cfg.max_segments, model.safety_margin


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_source")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k2_compare.py needs a CUDA device")
    card = chip_smoke.gpu_line()
    blk, S, sm = sim_track_blocks(torch.device("cuda:0"))
    B = blk.shape[0]
    with tempfile.TemporaryDirectory() as d:
        old = load_old(args.old_source, d)
        new = corridor_cuda.corridor_select_cuda
        ref = corridor_cuda.corridor_select_plain(blk, S, sm)
        for name, fn in (("old", old), ("new", new)):
            got = fn(blk, S, sm)
            torch.cuda.synchronize()
            same = all(chip_smoke.same_bits(a, b) for a, b in zip(got, ref))
            print(f"[K2 old vs new] {name} kernel bitwise equal to the plain "
                  f"version at B={B}: {same}", flush=True)
            if not same:
                raise AssertionError(f"{name} K2 differs from the plain version")
        for n in chip_smoke.SCALING_B:
            b = blk[:n].contiguous()
            t = [chip_smoke.device_ms(lambda: f(b, S, sm), args.reps)
                 for f in (old, new, new, old)]
            bnd = chip_smoke.bound(
                chip_smoke.nbytes(b, new(b, S, sm)), chip_smoke.count_ops(
                    lambda: corridor_cuda.corridor_select_plain(b, S, sm)))
            print(f"[K2 old vs new] B={n}, N={b.shape[1]}, S={S}: old "
                  f"{0.5 * (t[0] + t[3]):.5f} ms, new {0.5 * (t[1] + t[2]):.5f}"
                  f" ms, bound {bnd[0]:.5f} ms ({bnd[1]}) ({card})", flush=True)


if __name__ == "__main__":
    main()
