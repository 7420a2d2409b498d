"""K3 (``csrc/admm_structured.cu``, Schur stage solver): the ADMM of
``iterations`` x ``rho_updates`` + ``polish_iters`` iterations on ``B``
pre-assembled stage QPs at horizon ``N``."""


def ops(B: int, N: int, iterations: int, rho_updates: int,
        polish_iters: int) -> int:
    iters = iterations * rho_updates + polish_iters
    polish = 1 if polish_iters > 0 else 0
    lane = ((93 + 144 * N) + (167 + 326 * N) * iters
            + (978 + 1441 * N) * rho_updates + (1017 + 1497 * N) * polish)
    return B * lane + (30 + 25 * N) * (rho_updates + polish)


def nbytes(B: int, N: int) -> int:
    """Each input read once, each output written once."""
    return B * (228 + 296 * N)
