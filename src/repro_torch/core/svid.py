"""Sign-Value Independent Decomposition (paper Eq. 6), the port of
``repro.core.svid``.

SVID(P) = sign(P) ⊙ (a bᵀ) where a bᵀ is the best rank-1 approximation of
|P|. |P| is elementwise non-negative, so its leading singular vectors are
non-negative (Perron–Frobenius) and a few power iterations converge.
"""
from __future__ import annotations

import torch


def svid(p, n_iter: int = 12):
    """Best rank-1 sign-value proxy of p (m, n), or of each matrix of a
    stack (..., m, n)."""
    a, b = svid_factors(p, n_iter)
    return torch.sign(torch.where(p == 0, torch.ones_like(p), p)) \
        * (a[..., :, None] * b[..., None, :])


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def svid_factors(p, n_iter: int = 12):
    """(a, b) with |p| ≈ a bᵀ by power iteration on |p|, seeded with the
    column sums of |p| (one free half-step of the iteration); a stack of
    matrices gives a stack of factors."""
    ab = p.abs().float()
    b = _unit(ab.sum(dim=-2) + 1e-12)
    for _ in range(n_iter):
        a = _unit(_mv(ab, b))
        b = _unit(_mv(ab.mT, a))
    a = _mv(ab, b)
    sigma = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    a = a / torch.clamp(sigma, min=1e-12)
    # split sigma evenly so both factors carry comparable magnitude
    s = torch.sqrt(torch.clamp(sigma, min=1e-12))
    return a * s, b * s
