"""Binary low-rank gradient compression with error feedback, the port of
``repro.train.grad_compress``.

The paper's own representation, a rank-k sign-value factorization
(residual SVID), compresses a gradient:

    G ≈ Σ_i sign(R_i) ⊙ (a_i b_iᵀ),  R_0 = G,  R_{i+1} = R_i − Ĝ_i

Compression is lossy, so an error-feedback accumulator keeps the
optimizer unbiased over time (e ← g + e − decompress(compress(g + e))).
Bytes per leaf on a wire: k·(n+m)/8 (packed signs) + 4k·(n+m) (f32
factors) against 4·n·m uncompressed, :func:`compression_ratio`. The
reference's ``compressed_psum``, the collective that exchanges the
factors across a data-parallel axis, comes with the port's other
collectives (ROADMAP item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import util
from repro_torch.core.svid import svid_factors


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    rank: int = 4                 # residual SVID planes per tensor
    min_size: int = 65536         # leave small leaves uncompressed
    power_iters: int = 4


def _as2d(g: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    shape = tuple(g.shape)
    if g.dim() == 1:
        return g.reshape(1, -1), shape
    return g.reshape(-1, shape[-1]), shape


def compress_leaf(g: torch.Tensor, cfg: CompressConfig):
    """-> {"signs" (k, m, n) ±1, "a" (k, m), "b" (k, n), "shape"}: the
    residual rank-k SVID of `g` in f32."""
    res, shape = _as2d(g.float())
    signs, aa, bb = [], [], []
    for _ in range(cfg.rank):
        a, b = svid_factors(res, cfg.power_iters)
        s = torch.sign(torch.where(res == 0, torch.ones_like(res), res))
        res = res - s * torch.outer(a, b)
        signs.append(s)
        aa.append(a)
        bb.append(b)
    return {"signs": torch.stack(signs), "a": torch.stack(aa),
            "b": torch.stack(bb), "shape": shape}


def decompress_leaf(c) -> torch.Tensor:
    recon = torch.einsum("kmn,km,kn->mn", c["signs"], c["a"], c["b"])
    return recon.reshape(c["shape"])


def compress_with_error_feedback(grads, err: Optional[Any],
                                 cfg: CompressConfig):
    """(decompressed grads, new error state); ``err=None`` starts from
    zeros. A leaf below ``min_size`` elements or of fewer than 2 dims
    passes through with a zero error."""
    if err is None:
        err = util.tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g, e):
        if g.numel() < cfg.min_size or g.dim() < 2:
            return g, torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device)
        corrected = g.float() + e
        d = decompress_leaf(compress_leaf(corrected, cfg))
        return d.to(g.dtype), corrected - d

    out = util.tree_map(one, grads, err)
    return (util.tree_map(lambda o: o[0], out),
            util.tree_map(lambda o: o[1], out))


def compression_ratio(g_shape: tuple, cfg: CompressConfig) -> float:
    """Wire-bytes ratio for one tensor (packed signs + f32 factors vs
    f32)."""
    if len(g_shape) < 2:
        return 1.0
    m = 1
    for s in g_shape[:-1]:
        m *= s
    n = g_shape[-1]
    raw = 4.0 * m * n
    comp = cfg.rank * (m * n / 8.0 + 4.0 * (m + n))
    return comp / raw
