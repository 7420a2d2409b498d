"""Whether two sources of kernels K1 and K3 compile to the same machine code.

    python tools/admm_sass_diff.py OLD_CSRC_DIR [NEW_CSRC_DIR]

Compiles ``admm_fused.cu`` and ``admm_structured.cu`` of both directories
(NEW defaults to the package's ``csrc``) with the package's nvcc flags to
cubins, disassembles them with ``cuobjdump -sass`` and compares each
kernel's instantiations instruction by instruction, addresses and
encodings left out: the Schur one (``<false>``) and the cyclic-reduction
one (``<true>``).  Prints one line per kernel and instantiation: identical
or not, and the instruction counts.  Needs the CUDA toolkit (the card's
machine); a change that must leave one stage solver's code as it was
(for example the Schur instantiation under a redesign of the CR one)
shows it here.
"""

import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multi_purpose_mpc_tpu_torch.utils import kernels  # noqa: E402


def sass(source: str) -> dict:
    """``{"schur": [instruction, ...], "cr": [...]}`` of one kernel source."""
    nvcc = kernels.nvcc()
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as d:
        cubin = os.path.join(d, "k.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, source],
                       check=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n")[0]
        code = [re.sub(r"\s+", " ", m.group(1)).strip()
                for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", func)]
        out["cr" if "ILb1E" in name else "schur"] = code
    return out


def main():
    old = sys.argv[1]
    new = sys.argv[2] if len(sys.argv) > 2 else str(kernels.SRC_DIR)
    for name in ("admm_fused", "admm_structured"):
        a = sass(os.path.join(old, f"{name}.cu"))
        b = sass(os.path.join(new, f"{name}.cu"))
        for inst in ("schur", "cr"):
            print(f"[sass] {name} {inst}: "
                  f"{'identical' if a[inst] == b[inst] else 'different'} "
                  f"({len(a[inst])} -> {len(b[inst])} instructions)",
                  flush=True)


if __name__ == "__main__":
    main()
