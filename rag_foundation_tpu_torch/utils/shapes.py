"""Shape/tiling math shared by ops and engine layers."""

from __future__ import annotations


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= max(x, multiple)."""
    return max(multiple, -(-x // multiple) * multiple)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bucket_pow2(n: int, minimum: int = 1) -> int:
    """Next power of two >= n (batch-shape bucketing to bound retraces)."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b
