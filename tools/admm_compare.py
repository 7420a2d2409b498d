"""Kernels K1 and K3 against an earlier version of their sources, on the card.

    python tools/admm_compare.py OLD_CSRC_DIR [N]

``OLD_CSRC_DIR`` holds an ``admm_fused.cu``, an ``admm_structured.cu`` and
their ``admm_core.cuh`` with the package's C interface (for example the
parent commit's ``multi_purpose_mpc_tpu_torch/csrc``, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists).  Both are built with
the package's nvcc flags, the old one into a temporary directory.  For each
kernel and stage solver (Schur, cyclic reduction) the script checks on
synthetic inputs in the Sim_Track ranges at the production solver budget
(B = 4096, horizon N, default 30) that the two sources give the same bits,
then times them in turns (old, new, new, old; each time the mean of its
two, CUDA events) at B = 1, 128, 1024 and 4096 and prints one line per
kernel with the card's name and power limit.
"""

import ctypes
import dataclasses
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
from multi_purpose_mpc_tpu_torch.ops import admm_cuda  # noqa: E402
from multi_purpose_mpc_tpu_torch.ops.ltv_qp import (  # noqa: E402
    init_solver_carry)
from multi_purpose_mpc_tpu_torch.utils import kernels  # noqa: E402

BATCHES = (1, 128, 1024, 4096)


def build_old(src_dir: str, out_dir: str) -> dict:
    """``{"fused": fn, "structured": fn}``: the old launch functions, bound
    as the wrappers bind the package's."""
    fns = {}
    for kind, nargs, params in (("fused", 20, admm_cuda._Params),
                                ("structured", 18, admm_cuda._SolverParams)):
        lib = os.path.join(out_dir, f"libadmm_{kind}_old.so")
        proc = subprocess.run(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
             os.path.join(src_dir, f"admm_{kind}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old admm_{kind}.cu:\n"
                               f"{proc.stderr}")
        fn = getattr(ctypes.CDLL(lib), f"admm_{kind}_launch")
        fn.argtypes = [ctypes.c_void_p] * nargs + [ctypes.c_int] * 3 + [
            params, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[kind] = fn
    return fns


def inputs(B: int, N: int, dev):
    """K1's arguments and K3's ``(sq, warm, solver)`` for B lanes, drawn
    from numpy as tools/admm_parts.py draws them."""
    _, _, model, cfg, _, _ = sim_track_preset(os.path.join(REPO, "assets",
                                                            "maps"))
    rng = np.random.default_rng(B)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    u = lambda lo, hi, *s: t(rng.uniform(lo, hi, (B,) + s))
    half, ctr = u(0.0, 0.08, N), u(-0.05, 0.05, N)
    x0 = torch.stack([u(-0.06, 0.06), u(-0.2, 0.2), t(np.zeros(B))], -1)
    args = [u(0.4, 1.2, N), u(-4.0, 4.0, N), u(0.03, 0.06, N), ctr - half,
            ctr + half, x0, u(-4.0, 4.0, N),
            init_solver_carry(N, B, cfg.solver.rho, dev), cfg.solver, cfg,
            model]
    sq, _ = admm_cuda.assemble_stage_qp(*args[:7], cfg, model)
    sq = dataclasses.replace(sq, **{f: getattr(sq, f).contiguous()
                                    for f in ("AB", "beq", "Pd", "qv", "lw",
                                              "uw")})
    return args, (sq, args[7], cfg.solver)


def main():
    old_dir = sys.argv[1]
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    dev = torch.device("cuda:0")
    card = chip_smoke.gpu_line()
    with tempfile.TemporaryDirectory() as d:
        old = build_old(old_dir, d)
        new = {"fused": admm_cuda._library(),
               "structured": admm_cuda._structured_library()}
        originals = (admm_cuda._library, admm_cuda._structured_library)

        def use(fns):
            admm_cuda._library = lambda: fns["fused"]
            admm_cuda._structured_library = lambda: fns["structured"]

        try:
            for solver_name in ("cr", "schur"):
                runs = {}
                for B in BATCHES:
                    k1, (sq, warm, solver) = inputs(B, N, dev)
                    solver = dataclasses.replace(solver,
                                                 stage_solver=solver_name)
                    k1[8] = solver
                    runs[B] = {
                        "K1": lambda k1=k1: admm_cuda.solve_mpc_qp_fused_cuda(
                            *k1),
                        "K3": lambda a=(sq, warm, solver):
                            admm_cuda.solve_ltv_qp_structured_cuda(*a)}
                for kernel in ("K1", "K3"):
                    fn = runs[BATCHES[-1]][kernel]
                    use(old)
                    ref = fn()
                    use(new)
                    got = fn()
                    torch.cuda.synchronize()
                    same = all(chip_smoke.same_bits(a, b)
                               for a, b in zip(got, ref))
                    line = []
                    for B in BATCHES:
                        fn = runs[B][kernel]
                        t = []
                        for fns in (old, new, new, old):
                            use(fns)
                            t.append(chip_smoke.cuda_ms(fn, 10))
                        o, n = 0.5 * (t[0] + t[3]), 0.5 * (t[1] + t[2])
                        line.append(f"B={B}: old {o:.4f}, new {n:.4f} "
                                    f"({o / n:.2f}x)")
                    label = kernel + ("-CR" if solver_name == "cr" else "")
                    print(f"[{label} compare] N={N}, ms a launch: "
                          + ", ".join(line)
                          + f"; new bitwise equal to old at B={BATCHES[-1]}: "
                          f"{same} ({card})", flush=True)
                    if not same:
                        raise AssertionError(f"{label}: old and new differ")
        finally:
            admm_cuda._library, admm_cuda._structured_library = originals


if __name__ == "__main__":
    main()
