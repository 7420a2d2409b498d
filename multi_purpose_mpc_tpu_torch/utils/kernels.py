"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled by
``nvcc`` into ``lib<name>.so`` at first use, inside ``_build/<hash>/`` next
to the sources (listed in ``.gitignore``), where the hash covers the source
and the flags: an edited source rebuilds, an unchanged one loads.  The
library is opened with ctypes; the wrapper modules bind argument types.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math`` (the kernels rely on
IEEE division and square root, on +-inf bounds and on ``isfinite``), and
``-fmad=false`` so that ``a * b + c`` is rounded twice, as in the plain
PyTorch twins each kernel is held against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
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
    src = SRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and open ``lib<name>.so`` (once per process)."""
    return ctypes.CDLL(str(build(name)))


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
