"""K6 (``csrc/writeback_extract_packed.cu``): ``nb`` LiDAR hits written
into ``B`` maps bit-packed 32 rows a word ((WR, W) int32 words each), then
the (N, K) scanline samples read back."""


def ops(B: int, WR: int, W: int, nb: int) -> int:
    return B * (160 * WR * W + 4 * nb + 1)


def nbytes(B: int, WR: int, W: int, nb: int, N: int, K: int) -> int:
    """The packed maps read and written, the hits read, the samples'
    coordinates read and their values written."""
    return B * (8 * WR * W + 9 * nb + 12 * N * K)
