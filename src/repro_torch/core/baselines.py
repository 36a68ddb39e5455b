"""Baseline binarizers and alternative low-rank-binary initializers, the
port of ``repro.core.baselines``.

- RTN / XNOR in-place binarization (paper Table 2 rows 1-2)
- Dual-SVID init (LittleBit) — SVD factors, scales from row-mean
  magnitudes of each factor (Table 5)
- DBF-ADMM init — ADMM with a plain sign/global-scale proxy instead of
  the SVID rank-1 value structure, no Hessian preconditioning (Table 5)
"""
from __future__ import annotations

import torch

from repro_torch.core import admm as _admm
from repro_torch.core.svid import svid


def rtn_binarize(w):
    """W ≈ α·sign(W), α = per-tensor mean |W| (w in (d_in, d_out))."""
    wf = w.float()
    return wf.abs().mean() * torch.sign(wf)


def xnor_binarize(w):
    """W ≈ sign(W)·diag(α) with per-output-channel α over d_out columns."""
    wf = w.float()
    return wf.abs().mean(dim=0, keepdim=True) * torch.sign(wf)


def dual_svid_init(w, rank: int):
    """LittleBit-style init: truncated SVD W ≈ A Bᵀ (A = UΣ^½, B = VΣ^½),
    then scales and latents read off the factors. w: (d_in, d_out), or
    stacked experts (E, d_in, d_out), each decomposed alone."""
    W = w.float().mT                                   # (dout, din)
    u, s, vt = torch.linalg.svd(W, full_matrices=False)
    r = min(rank, s.shape[-1])
    sq = torch.sqrt(s[..., None, :r])
    a = u[..., :, :r] * sq                             # (dout, r)
    b = vt[..., :r, :].mT * sq                         # (din, r)
    return {"lu": a, "lv": b, "s1": a.abs().mean(dim=-1),
            "s2": b.abs().mean(dim=-1)}


def _sign_proxy(p):
    return p.abs().mean(dim=(-2, -1), keepdim=True) * torch.sign(p)


def dbf_admm_init(w, rank: int, iters: int = 40, rho: float = 1.0,
                  key=None):
    """DBF-flavoured ADMM: the LB-ADMM splitting with a plain global-scale
    sign proxy (Z = mean|P|·sign(P)) and an unpreconditioned target.
    w: (d_in, d_out), or stacked experts (E, d_in, d_out), each solved
    alone."""
    W = w.float().mT
    u, v = _admm._rand_range_init(key if key is not None else (0,), W, rank)
    zu, zv = _sign_proxy(u), _sign_proxy(v)
    lu = torch.zeros_like(u)
    lv = torch.zeros_like(v)
    for _ in range(iters):
        u = _admm._chol_solve_ridge(v.mT @ v, v.mT @ W.mT + rho * (zu - lu).mT,
                                    rho).mT
        v = _admm._chol_solve_ridge(u.mT @ u, u.mT @ W + rho * (zv - lv).mT,
                                    rho).mT
        pu, pv = u + lu, v + lv
        zu, zv = _sign_proxy(pu), _sign_proxy(pv)
        lu, lv = pu - zu, pv - zv
    pu, pv = u + lu, v + lv
    return {"lu": pu, "lv": pv, "s1": pu.abs().mean(dim=-1),
            "s2": pv.abs().mean(dim=-1)}


def svid_rank1(w):
    """Rank-1 SVID of a full matrix."""
    return svid(w.float())
