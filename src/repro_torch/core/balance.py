"""Latent magnitude balancing and scale extraction (paper §3.2 Step 2-3,
Eq. 7–9), the port of ``repro.core.balance``.

Removes the η / η⁻¹ scale ambiguity of the factorization by equalizing
Frobenius norms (the minimum-energy representative, Prop. 1), then reads
channel scales off the balanced projections.
"""
from __future__ import annotations

import torch


def magnitude_balance(p_u, p_v, d_out, d_in):
    """p_u: (m, r), p_v: (n, r) ADMM consensus proxies; d_out: (m,),
    d_in: (n,) diagonal preconditioners; a leading expert axis on all four
    balances each expert alone. Returns (latent_u (m, r), latent_v (n, r),
    s1 (m,), s2 (n,)) such that
    W ≈ diag(s1)·sign(latent_u)·sign(latent_v)ᵀ·diag(s2)."""
    u_hat = p_u / d_out[..., :, None]       # D̃_out⁻¹ P_U
    v_hat = p_v / d_in[..., :, None]        # D̃_in⁻¹ P_V
    nu = torch.clamp(torch.linalg.vector_norm(u_hat, dim=(-2, -1),
                                              keepdim=True), min=1e-12)
    nv = torch.clamp(torch.linalg.vector_norm(v_hat, dim=(-2, -1),
                                              keepdim=True), min=1e-12)
    eta = torch.sqrt(nv / nu)               # Eq. 7
    lat_u = eta * u_hat                     # Eq. 9
    lat_v = v_hat / eta
    s1 = lat_u.abs().mean(dim=-1)           # Eq. 8 (row means)
    s2 = lat_v.abs().mean(dim=-1)
    return lat_u, lat_v, s1, s2


def reconstruct(lat_u, lat_v, s1, s2):
    """Ŵ (m, n) = diag(s1) sign(U) sign(V)ᵀ diag(s2)."""
    return (s1[:, None] * torch.sign(lat_u)) @ (torch.sign(lat_v).T
                                                * s2[None, :])
