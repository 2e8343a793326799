"""Power-of-two extents (the reference's nextPowerOfTwo)."""

from __future__ import annotations


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p
