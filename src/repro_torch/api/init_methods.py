"""Pluggable low-rank-binary initialization methods (paper Table 5), the
port of ``repro.api.init_methods``.

An init method maps one FP linear to the latent dict the STE refinement
phase consumes::

    @register_init_method("my_init")
    def my_init(w, d_in, d_out, *, rank, admm, key):
        # w: (d_in, d_out) weights; d_in / d_out: diagonal K-FAC
        # preconditioners; admm: repro_torch.core.admm.ADMMConfig; key:
        # the draw's key path (repro_torch.core.admm)
        return {"lu": ..., "lv": ..., "s1": ..., "s2": ...}

``core.pipeline`` resolves ``QuantConfig.init_method`` (and the fallback
ladder's names) through this registry on every call. The built-ins are
``lb_admm`` (the paper's method), ``dual_svid`` (LittleBit-style) and
``dbf_admm`` (DBF-flavoured, no Hessian preconditioning).
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.api.registry import Registry
from repro_torch.core import baselines, quantize

INIT_METHODS = Registry("init method")
register_init_method = INIT_METHODS.register


def get_init_method(name: str) -> Callable:
    return INIT_METHODS.get(name)


def list_init_methods() -> List[str]:
    return INIT_METHODS.names()


@register_init_method("lb_admm")
def lb_admm_init(w, d_in, d_out, *, rank, admm, key):
    """Paper §3.2: preconditioned LB-ADMM + magnitude balancing."""
    lat, _ = quantize.quantize_weight(w, d_in, d_out, rank, admm, key)
    return lat


@register_init_method("dual_svid")
def dual_svid_init(w, d_in, d_out, *, rank, admm, key):
    """LittleBit-style truncated-SVD init (ignores preconditioners)."""
    return baselines.dual_svid_init(w, rank)


@register_init_method("dbf_admm")
def dbf_admm_init(w, d_in, d_out, *, rank, admm, key):
    """DBF-flavoured ADMM: plain sign/global-scale proxy, no Hessian."""
    return baselines.dbf_admm_init(w, rank, iters=admm.iters, key=key)
