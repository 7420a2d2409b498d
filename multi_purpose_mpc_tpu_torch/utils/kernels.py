"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled by
``nvcc`` into ``lib<name>.so`` at first use, inside ``_build/<hash>/`` next
to the sources (listed in ``.gitignore``), where the hash covers the source,
every shared header ``csrc/*.cuh`` and the flags: an edited source or
header rebuilds, an unchanged one loads.  The library is opened with
ctypes; the wrapper modules bind argument types.  :func:`build_all` runs
one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math`` (the kernels rely on
IEEE division and square root, on +-inf bounds and on ``isfinite``), and
``-fmad=false`` so that ``a * b + c`` is rounded twice, as in the plain
PyTorch twins each kernel is held against.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    key = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / key.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an identical build exists."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build_all(names) -> dict:
    """Build several kernels at once (one ``nvcc`` process each); returns
    ``{name: seconds}``.  Raises the first build error."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and open ``lib<name>.so`` (once per process)."""
    return ctypes.CDLL(str(build(name)))


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def launch_counters() -> dict:
    """Each kernel's launch counter, ``{name: (wrapper, attribute)}``: a
    wrapper adds one where it launches its kernel, and nowhere else.  K1
    and K3 count their Schur and their cyclic-reduction instantiations
    apart."""
    from multi_purpose_mpc_tpu_torch.ops import (admm_cuda, corridor_cuda,
                                                 corridor_extract, mapping)

    return {"admm_fused": (admm_cuda.solve_mpc_qp_fused_cuda, "launches"),
            "admm_fused_cr": (admm_cuda.solve_mpc_qp_fused_cuda,
                              "launches_cr"),
            "corridor_select": (corridor_cuda.corridor_select_cuda,
                                "launches"),
            "admm_structured": (admm_cuda.solve_ltv_qp_structured_cuda,
                                "launches"),
            "admm_structured_cr": (admm_cuda.solve_ltv_qp_structured_cuda,
                                   "launches_cr"),
            "extract_occ": (corridor_extract.extract_occ_cuda, "launches"),
            "writeback_extract": (mapping.writeback_extract_cuda, "launches"),
            "writeback_extract_packed": (
                mapping.writeback_extract_packed_cuda, "launches")}


def launch_counts() -> dict:
    """Every counter of :func:`launch_counters` as ``{name: count}``."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def add_launches(counts: dict) -> None:
    """Add ``{name: n}`` to the wrappers' counters: a replayed CUDA graph
    launches the kernels its capture recorded without running the
    wrappers, so it adds the capture's counts once per replay
    (:mod:`.graphs`).  ``n`` may be negative."""
    for name, (fn, attr) in launch_counters().items():
        if counts.get(name):
            setattr(fn, attr, getattr(fn, attr) + counts[name])


def ptxas_report(name: str) -> str:
    """ptxas's resource report (registers, stack, shared memory, spills)
    of ``csrc/<name>.cu`` compiled with the build flags."""
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               os.path.join(d, "lib.so"),
                               str(SRC_DIR / f"{name}.cu")],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    return proc.stderr


if __name__ == "__main__":
    # python -m multi_purpose_mpc_tpu_torch.utils.kernels [name ...]
    import sys

    for kernel in sys.argv[1:] or sorted(p.stem for p in SRC_DIR.glob("*.cu")):
        print(f"== {kernel}.cu\n{ptxas_report(kernel)}", flush=True)
