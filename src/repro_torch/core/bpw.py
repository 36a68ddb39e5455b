"""Bits-per-weight accounting (paper App. F): the rank a linear gets at a
target bpw. The port's copy of ``repro.core.bpw.rank_for_bpw``."""
from __future__ import annotations


def rank_for_bpw(n: int, m: int, bpw: float, align: int = 32,
                 r_min: int = 32) -> int:
    """Largest rank whose NanoQuant storage stays <= target bpw
    (Eq. 59 inverted: r = bpw·nm/(n+m) − 16), floored to `align` and
    clamped to r_min. Packing stores U transposed in 32-bit words, so
    the effective alignment is always a multiple of 32."""
    align = max(32, (align // 32) * 32 or 32)
    r = bpw * n * m / (n + m) - 16.0
    r = int(r // align) * align
    return max(max(r_min, 32), r)
