"""Where kernel K1's time goes: K1 timed with one part of its solve switched
off, on the card.

    python tools/admm_parts.py [N] [--cr]

Builds four variants of ``csrc/admm_fused.cu`` into a temporary directory:
the kernel as it is, and the kernel with the stage substitutions
(``substitute``), the Schur factorisation (``factor``) or the
stage-parallel work of an iteration (right-hand side, projection, dual
updates) returning at once.  With ``--cr`` the kernel runs its
cyclic-reduction stage solver (``SolverConfig(stage_solver="cr")``) and
the variants switch off its solve (``cr_solve``) and its factorisation
(``cr_factor``) instead.  Each variant is timed in its own process (a
library is loaded once per process) with CUDA events at B = 1, 1024 and
4096 on the same synthetic inputs, at the production solver budget.  A
switched-off variant computes nothing meaningful; only its time is read:
the difference to the full kernel is that part's share.  Prints one line
per variant and the card's name and power limit.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
CORE = REPO / "multi_purpose_mpc_tpu_torch" / "csrc"
BATCHES = (1, 1024, 4096)

# variant -> (function signature line, line inserted after it), per stage
# solver
STAGE_PARALLEL_OFF = ("float rho_eq) {\n  // right-hand side", None)
OFF = {
    "substitute off": ("void substitute(const Lane& L) {",
                       "  if (L.N > 0) return;"),
    "factor off": ("void factor(const Lane& L) {", "  if (L.N > 0) return;"),
    "stage-parallel work off": STAGE_PARALLEL_OFF,
}
OFF_CR = {
    "cr_solve off": ("void cr_solve(const Lane& L) {",
                     "  if (L.N > 0) return;"),
    "cr_factor off": ("void cr_factor(const Lane& L) {",
                      "  if (L.N > 0) return;"),
    "stage-parallel work off": STAGE_PARALLEL_OFF,
}


def make_variant(root: pathlib.Path, name: str, off: dict) -> pathlib.Path:
    src = root / name.replace(" ", "_") / "csrc"
    shutil.copytree(CORE, src)
    if name in off:
        path = src / "admm_core.cuh"
        text = path.read_text()
        anchor, line = off[name]
        assert text.count(anchor) == 1, anchor
        if line is None:  # iteration() keeps only the stage solve
            head, tail = text.split(anchor)
            body_end = tail.index("\n}\n")
            text = (head + "float rho_eq) {\n  if constexpr (CR) cr_solve(L);"
                    " else substitute(L);" + tail[body_end:])
        else:
            text = text.replace(anchor, anchor + "\n" + line)
        path.write_text(text)
    return src


def time_variant(src: str, N: int, stage_solver: str) -> str:
    import torch

    sys.path.insert(0, str(REPO))
    from multi_purpose_mpc_tpu_torch.utils import kernels

    kernels.SRC_DIR = pathlib.Path(src)
    kernels.BUILD_DIR = pathlib.Path(src).parent / "_build"
    from multi_purpose_mpc_tpu_torch.config import sim_track_preset
    from multi_purpose_mpc_tpu_torch.ops import admm_cuda
    from multi_purpose_mpc_tpu_torch.ops.ltv_qp import init_solver_carry

    import numpy as np

    import dataclasses

    _, _, model, cfg, _, _ = sim_track_preset(str(REPO / "assets" / "maps"))
    solver = dataclasses.replace(cfg.solver, stage_solver=stage_solver)
    dev = torch.device("cuda:0")
    out = []
    for B in BATCHES:
        rng = np.random.default_rng(B)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        u = lambda lo, hi, *s: t(rng.uniform(lo, hi, (B,) + s))
        half, ctr = u(0.0, 0.08, N), u(-0.05, 0.05, N)
        x0 = torch.stack([u(-0.06, 0.06), u(-0.2, 0.2), t(np.zeros(B))], -1)
        args = (u(0.4, 1.2, N), u(-4.0, 4.0, N), u(0.03, 0.06, N), ctr - half,
                ctr + half, x0, u(-4.0, 4.0, N),
                init_solver_carry(N, B, cfg.solver.rho, dev), solver, cfg,
                model)
        fn = lambda: admm_cuda.solve_mpc_qp_fused_cuda(*args)
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(f"B={B}: {start.elapsed_time(end) / 10:.4f} ms")
    return ", ".join(out)


def main():
    cr = "--cr" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cr"]
    N = int(args[0]) if args else 30
    off, solver, label = (OFF_CR, "cr", "K1-CR") if cr else (OFF, "auto",
                                                               "K1")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        for name in ("full kernel",) + tuple(off):
            src = make_variant(pathlib.Path(d), name, off)
            res = subprocess.run(
                [sys.executable, __file__, "--time", str(src), str(N), solver],
                capture_output=True, text=True, env=dict(os.environ))
            if res.returncode != 0:
                raise RuntimeError(f"{name}: {res.stderr[-2000:]}")
            print(f"[{label} parts] N={N}, {name}: {res.stdout.strip()} "
                  f"({card})", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--time":
        print(time_variant(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    else:
        main()
