"""Robust diagonal K-FAC preconditioners (paper Alg. 1 Phase 1, Eq. 2–3),
the port of ``repro.core.precond``.

:class:`StatCollector` accumulates, per named linear layer, the diagonal
of the activation second moment (A = E[x xᵀ] diag, field ``"in"``) and of
the output-gradient second moment (G = E[g gᵀ] diag, field ``"out"``). The
diagonal preconditioners are D_in = diag(A)^½, D_out = diag(G)^½, so that
‖D_out (W−Ŵ) D_in‖² is the diagonal K-FAC approximation of the task-loss
Hessian quadratic form. :func:`robust_diag` applies Ledoit–Wolf-style
shrinkage toward the mean plus clipping (Eq. 3).

The taps are ``models.layers``': while :func:`collect_stats` runs, every
named ``dense`` call records its input's squares before the matmul and
hooks its output tensor for the gradient's. Both fields come from one
forward and backward per batch (the JAX package takes them in a forward
pass and a gradient pass; the two forwards compute the same values).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


class StatCollector:
    """Accumulator the taps feed. Keys: (stack, name, field, layer_idx) ->
    {'sq': float64 tensor (d,) on the model's device, 'cnt': float}; each
    call adds the f32 sum of squares over every axis but the last, and
    ``x.numel() // x.shape[-1]`` rows. A stacked-expert linear's tensors
    are (E, C, d): its sums reduce the capacity axis only, giving (E, d),
    and count its C rows, padding and dropped slots included (the JAX
    package's expert taps)."""

    def __init__(self):
        self.data: Dict[Tuple, dict] = {}

    def accumulate(self, stack: str, name: str, field: str, idx, t,
                   expert: bool = False) -> None:
        red = (1,) if expert else tuple(range(t.dim() - 1))
        sq = t.detach().float().square().sum(dim=red).double()
        key = (stack, name, field, int(-1 if idx is None else idx))
        slot = self.data.setdefault(key, {"sq": torch.zeros_like(sq),
                                          "cnt": 0.0})
        slot["sq"] += sq
        slot["cnt"] += float(t.shape[1] if expert
                             else t.numel() // t.shape[-1])

    # ---- lookups -----------------------------------------------------------

    def mean_sq(self, stack: str, name: str, field: str, idx: int):
        slot = self.data.get((stack, name, field, idx))
        if slot is None:
            return None
        return slot["sq"].cpu().numpy() / max(slot["cnt"], 1.0)

    def mean_sq_agg(self, stack: str, name: str, field: str):
        """Aggregate over all layer indices (a block applied at several
        depths)."""
        tot, cnt = None, 0.0
        for (s, n, f, _), slot in self.data.items():
            if (s, n, f) == (stack, name, field):
                sq = slot["sq"].cpu().numpy()
                tot = sq if tot is None else tot + sq
                cnt += slot["cnt"]
        if tot is None:
            return None
        return tot / max(cnt, 1.0)


def robust_diag(mean_sq: np.ndarray, gamma: float, eps: float = 1e-6,
                tau_max: float = 1e4, device="cpu") -> torch.Tensor:
    """Per-channel second moment -> shrunk, clipped, normalized diagonal
    preconditioner (paper Eq. 3 + Lemma 1 clipping), f32 on `device`."""
    d = np.sqrt(np.maximum(mean_sq, 0.0))
    d = (1.0 - gamma) * d + gamma * d.mean()
    d = np.clip(d, eps, tau_max)
    d = d / max(d.mean(), 1e-12)          # scale-free (cancelled by balancing)
    return torch.from_numpy(np.asarray(d, np.float32)).to(device)


def collect_stats(loss_fn, params, cfg, batches) -> StatCollector:
    """Run the calibration batches through the FP model with the taps
    installed: a forward and a backward per batch. The backward runs to
    the embedding table (a detached copy) and to the VLM's image
    embeddings (likewise), so no parameter gradient is kept; the taps
    read the gradient of every linear's output, the image K/V
    projections' (``xattn.wk`` / ``xattn.wv``, fed by the images alone)
    included."""
    from repro_torch.models import layers as L

    collector = StatCollector()
    with L.taps(collector), torch.enable_grad():
        for b in batches:
            p = dict(params, embed=params["embed"].detach().requires_grad_())
            inputs = [p["embed"]]
            if "image_embeds" in b:
                img = b["image_embeds"].to(p["embed"].device).detach()
                b = dict(b, image_embeds=img.requires_grad_())
                inputs.append(img)
            loss = loss_fn(p, cfg, b, training=False)
            torch.autograd.grad(loss, inputs)
    return collector


def preconditioners_for(collector: StatCollector, stack: str, name: str,
                        idx, d_in_dim: int, d_out_dim: int, gamma: float,
                        expert_shape=None, device="cpu"):
    """(D_in, D_out) for one linear, identity where the stats are missing
    (a layer the calibration never activated). `idx` None aggregates over
    every layer index. With `expert_shape` E (stacked experts) each is
    (E, d), one robust diagonal per expert."""
    if idx is None:
        a = collector.mean_sq_agg(stack, name, "in")
        g = collector.mean_sq_agg(stack, name, "out")
    else:
        a = collector.mean_sq(stack, name, "in", idx)
        g = collector.mean_sq(stack, name, "out", idx)

    def diag(ms, dim):
        if expert_shape is None:
            return (torch.ones((dim,), dtype=torch.float32, device=device)
                    if ms is None else robust_diag(ms, gamma, device=device))
        if ms is None:
            return torch.ones((expert_shape, dim), dtype=torch.float32,
                              device=device)
        return torch.stack([robust_diag(ms[e], gamma, device=device)
                            for e in range(expert_shape)])
    return diag(a, d_in_dim), diag(g, d_out_dim)
