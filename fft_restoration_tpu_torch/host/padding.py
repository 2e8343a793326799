"""DFT extents: the reference's power of two, and the smooth mixed-radix
sizes of `--pad smooth` (copied from fft_restoration_tpu/utils/padding.py)."""

from __future__ import annotations


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


# Odd factors the mixed-radix kernels take, as products of radix-3/5
# cross-DFT levels. Per octave the reachable sizes are {1, 9/8, 5/4,
# 3/2, 15/8, 2}·2^k: at most 25% pad waste instead of pow2's 100%.
_SMOOTH_ODD_RADICES = {3: (3,), 5: (5,), 9: (3, 3), 15: (3, 5)}


def next_smooth_size(n: int, min_q: int = 128) -> tuple:
    """Smallest s >= n of the form odd * 2^k with odd in {1, 3, 5, 9, 15}
    and 2^k >= min_q, as (s, radices): radices are the odd cross-DFT
    radices (outermost first) the kernels run, () for a power of two.

    min_q=128 is the TPU's lane width (the JAX kernels' pow2 tail must
    fill a (8, 128) vreg); the CUDA kernels have no such limit. It is kept
    so that the extents and radices equal the JAX package's, and is to be
    re-measured on the H100 (ROADMAP.md, dropped TPU gates)."""
    best = (next_power_of_two(n), ())
    for odd, radices in _SMOOTH_ODD_RADICES.items():
        q = min_q
        while odd * q < n:
            q <<= 1
        s = odd * q
        if s < best[0]:
            best = (s, radices)
    return best
