"""Per-layer quantization entry: preconditioning -> LB-ADMM -> balancing,
the port of ``repro.core.quantize``.

Operates on weights in the model's (d_in, d_out) layout; internally works
in the paper's (d_out, d_in) orientation. Returns *latent* dicts
({'lu', 'lv', 's1', 's2'}) for the STE refinement phase; packing happens
after refinement (:mod:`repro_torch.core.packing`).
"""
from __future__ import annotations

from repro_torch.core.admm import ADMMConfig, lb_admm
from repro_torch.core.balance import magnitude_balance
from repro_torch.core.bpw import rank_for_bpw


def quantize_weight(w, d_in, d_out, rank: int, admm: ADMMConfig, key):
    """w: (d_in, d_out); d_in: (d_in,), d_out: (d_out,) preconditioners.
    Stacked experts (w (E, d_in, d_out), preconditioners (E, d)) run one
    batched solve, expert e drawing from ``key + (E, e)``. Returns (latent
    dict with lu (d_out, r), lv (d_in, r), s1, s2, info)."""
    W = w.float().mT                         # paper layout (dout, din)
    Wt = d_out[..., :, None] * W * d_in[..., None, :]  # Alg. 1 line 15
    res = lb_admm(Wt, admm._replace(rank=rank), key)
    lat_u, lat_v, s1, s2 = magnitude_balance(res["p_u"], res["p_v"],
                                             d_out, d_in)
    return ({"lu": lat_u, "lv": lat_v, "s1": s1, "s2": s2},
            {"residual_trace": res["residual_trace"],
             "health": res["health"]})


def quantize_leaf(p: dict, d_in, d_out, target_bpw: float, admm: ADMMConfig,
                  key, rank_align: int = 32):
    """Quantize one linear param dict ({'w': (d_in, d_out)}, or stacked
    experts' (E, d_in, d_out) at one rank for all); a bias is carried
    over in FP. Returns (latent dict, info)."""
    w = p["w"]
    din, dout = w.shape[-2:]
    r = rank_for_bpw(dout, din, target_bpw, rank_align)
    lat, info = quantize_weight(w, d_in, d_out, r, admm, key)
    if "b" in p:
        lat["b"] = p["b"]
    info["rank"] = r
    return lat, info
