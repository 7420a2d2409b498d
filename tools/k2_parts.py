"""Where kernel K2's time goes: K2 timed beside variants of its own source
with one part of its design switched off, on the card.

    python tools/k2_parts.py [--reps 200]

Builds ``csrc/corridor_select.cu`` as it is and four variants made by text
substitution into a temporary directory, one nvcc each, in parallel:

* ``loads only``: the stage chain skipped (loads, waits and stores kept;
  computes nothing meaningful);
* ``cp.async copies``: the block's threads copy every chunk (the path of
  unaligned runs) instead of the tensor memory accelerator's bulk copies;
* ``IEEE sqrtf``: ``sqrtf`` (its slow-path branch included) in place of
  the branch-free ``sqrt_rn``;
* ``16 lanes a block``: twice the lanes a block, half the blocks.

On the Sim_Track horizon blocks of 4096 feasible starts (chip_smoke.py's
seed) every variant but ``loads only`` is checked bitwise against the plain
version; then all are timed in turns (the list, then the list reversed;
each time the mean of its two) with chip_smoke.device_ms at B = 1, 128,
1024 and 4096.  Prints one line per batch with the card's name and power
limit.
"""

import argparse
import concurrent.futures
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
from multi_purpose_mpc_tpu_torch.ops import corridor_cuda  # noqa: E402
from multi_purpose_mpc_tpu_torch.utils import kernels  # noqa: E402
from tools.k2_compare import bind, sim_track_blocks  # noqa: E402

SOURCE = os.path.join(REPO, "multi_purpose_mpc_tpu_torch", "csrc",
                      "corridor_select.cu")
VARIANTS = {
    "as it is": [],
    "loads only": [("for (int j = 0; j < cc; ++j) {",
                    "for (int j = 0; j < 0; ++j) {")],
    "cp.async copies": [("const bool bulk = ", "const bool bulk = false && ")],
    "IEEE sqrtf": [("__device__ __forceinline__ float sqrt_rn(float x) {",
                    "__device__ __forceinline__ float sqrt_rn(float x) {\n"
                    "  return sqrtf(x);")],
    "16 lanes a block": [("constexpr int LANES = 8;",
                          "constexpr int LANES = 16;")],
}
APPROXIMATE = ("loads only",)


def build(name: str, subs, root: str) -> str:
    text = open(SOURCE).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once in the source")
        text = text.replace(old, new)
    stem = os.path.join(root, name.replace(" ", "_").replace(".", ""))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o",
                           stem + ".so", stem + ".cu"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return stem + ".so"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k2_parts.py needs a CUDA device")
    card = chip_smoke.gpu_line()
    blk, S, sm = sim_track_blocks(torch.device("cuda:0"))
    ref = corridor_cuda.corridor_select_plain(blk, S, sm)
    with tempfile.TemporaryDirectory() as d:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = {k: pool.submit(build, k, v, d) for k, v in VARIANTS.items()}
            fns = {k: bind(ctypes.CDLL(f.result()).corridor_select_launch)
                   for k, f in libs.items()}
        for name, fn in fns.items():
            if name in APPROXIMATE:
                continue
            got = fn(blk, S, sm)
            torch.cuda.synchronize()
            if not all(chip_smoke.same_bits(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"K2 variant {name} differs from the "
                                     f"plain version")
        print("[K2 parts] every variant but 'loads only' bitwise equal to the "
              "plain version", flush=True)
        names = list(fns)
        for n in chip_smoke.SCALING_B:
            b = blk[:n].contiguous()
            t = {k: [] for k in names}
            for order in (names, names[::-1]):
                for k in order:
                    t[k].append(chip_smoke.device_ms(lambda: fns[k](b, S, sm),
                                                     args.reps))
            print(f"[K2 parts] B={n}, N=30, S={S}, device ms: " + ", ".join(
                f"{k} {np.mean(v):.5f}" for k, v in t.items()) + f" ({card})",
                flush=True)


if __name__ == "__main__":
    main()
