"""Effective bits-per-weight and model-size accounting (paper App. F),
the port's copy of ``repro.core.bpw``: the exact storage formulas of
NanoQuant and of every baseline in Tables 13–14, and the rank a linear
gets at a target bpw.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple


def rank_for_bpw(n: int, m: int, bpw: float, align: int = 32,
                 r_min: int = 32) -> int:
    """Largest rank whose NanoQuant storage stays <= target bpw
    (Eq. 59 inverted: r = bpw·nm/(n+m) − 16), floored to `align` for
    packing/MXU friendliness and clamped to r_min. Packing stores U
    transposed in 32-bit words, so the effective alignment is always a
    multiple of 32."""
    align = max(32, (align // 32) * 32 or 32)
    r = bpw * n * m / (n + m) - 16.0
    r = int(r // align) * align
    return max(max(r_min, 32), r)


def nanoquant_bits(n: int, m: int, r: int) -> int:
    """M_NanoQuant = r(n+m) + 16(n+m)   (Eq. 58)."""
    return r * (n + m) + 16 * (n + m)


def nanoquant_bpw(n: int, m: int, r: int) -> float:
    return nanoquant_bits(n, m, r) / (n * m)


def dbf_bits(n: int, m: int, r: int) -> int:
    """M_DBF = r(n+m) + 16(n+r+m)   (Eq. 55) — extra rank-wise scale."""
    return r * (n + m) + 16 * (n + r + m)


def billm_bits(n: int, m: int, c: int = 50, k: int = 128) -> int:
    """Eq. 44: n(2m+c) + m + 112 n ceil(m/k)."""
    return n * (2 * m + c) + m + 112 * n * math.ceil(m / k)


def stbllm_bits(n: int, m: int, N: int, M: int, c: int = 50, k: int = 128) -> int:
    """Eq. 46 with N:M structured sparsity."""
    idx_bits = math.ceil(math.log2(math.comb(M, N)))
    total = (2 * n * c + math.ceil(m / k) * 3 * n * 16
             + (N / M) * (n * (m - c) + 2 * n * m)
             + (n * (m - c) / M) * idx_bits
             + math.ceil(m / k) * 2 * n * 16 * 3
             + m)
    return int(total)


def arbllm_rc_bits(n: int, m: int, c: int = 50, k: int = 128) -> int:
    """Eq. 48: n(2m+c) + 33m + 64 n ceil(m/k)."""
    return n * (2 * m + c) + 33 * m + 64 * n * math.ceil(m / k)


def hbllm_row_bits(n: int, m: int, c: int = 50, k: int = 128) -> int:
    """Eq. 50: 2n(m+c) + m + 160 n ceil(m/k)."""
    return 2 * n * (m + c) + m + 160 * n * math.ceil(m / k)


def hbllm_col_bits(n: int, m: int, c: int = 50, k: int = 128) -> int:
    """Eq. 52: 2nm + m + 112 n ceil(m/k)."""
    return 2 * n * m + m + 112 * n * math.ceil(m / k)


METHODS = {
    "nanoquant": lambda n, m, r=None, bpw=1.0: nanoquant_bits(
        n, m, r if r is not None else rank_for_bpw(n, m, bpw)),
    "dbf": lambda n, m, r=None, bpw=1.0: dbf_bits(
        n, m, r if r is not None else rank_for_bpw(n, m, bpw)),
    "billm": lambda n, m, **_: billm_bits(n, m),
    "stbllm_4:8": lambda n, m, **_: stbllm_bits(n, m, 4, 8),
    "stbllm_6:8": lambda n, m, **_: stbllm_bits(n, m, 6, 8),
    "stbllm_8:8": lambda n, m, **_: stbllm_bits(n, m, 8, 8),
    "arbllm_rc": lambda n, m, **_: arbllm_rc_bits(n, m),
    "hbllm_row": lambda n, m, **_: hbllm_row_bits(n, m),
    "hbllm_col": lambda n, m, **_: hbllm_col_bits(n, m),
}


def model_bpw(layer_shapes: List[Tuple[int, int]], method: str,
              **kw) -> float:
    """Eq. 60: BPW over all quantized linear layers of a model.

    layer_shapes: list of (n=d_out, m=d_in) for every quantized linear."""
    fn = METHODS[method]
    total_bits = sum(fn(n, m, **kw) for n, m in layer_shapes)
    total_w = sum(n * m for n, m in layer_shapes)
    return total_bits / total_w


def model_size_gb(layer_shapes: List[Tuple[int, int]], method: str,
                  fp_params: int = 0, fp_bits: int = 16, **kw) -> float:
    """Checkpoint size in GB: quantized linears + FP16 residue (embeddings,
    norms, head — matching the paper's accounting)."""
    fn = METHODS[method]
    bits = sum(fn(n, m, **kw) for n, m in layer_shapes) + fp_params * fp_bits
    return bits / 8 / 1e9


def bpw_report(layer_shapes, fp_params: int = 0,
               target_bpw: float = 1.0) -> Dict[str, float]:
    out = {}
    for name in METHODS:
        kw = {"bpw": target_bpw} if name in ("nanoquant", "dbf") else {}
        out[name] = model_bpw(layer_shapes, name, **kw)
    return out
