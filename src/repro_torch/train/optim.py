"""AdamW with cosine / constant schedules and global-norm clipping over
parameter trees, the port of ``repro.train.optim``.

Functional, as the JAX package's: ``update(grads, state, params)``
returns new params and state. Moments are f32 whatever a parameter's
dtype is; the step's learning rate is read at ``state.step`` before the
increment, bias correction uses the incremented step, and the update is
computed in f32 and cast back to each parameter's dtype. Trees are
nested dicts whose None leaves (``core.util.partition`` placeholders)
are skipped; leaves are visited in JAX's order (sorted keys), so the
global norm sums in the same order. The state's step is a 0-d int32
CPU tensor, as JAX's is a 0-d int32 leaf, so that a training state
``(params, AdamState(step, m, v), eff)`` checkpoints in JAX's layout.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import util


class AdamState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the CPU
    m: Any
    v: Any


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.0) -> Callable:
    def lr(step):
        s = _f32(step)
        warm = torch.clamp((s + 1) / max(warmup, 1), max=1.0) \
            if warmup else 1.0
        t = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * warm * (final_frac + (1 - final_frac) * cos)
    return lr


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: _f32(base_lr)


def global_norm(tree):
    sq = [l.float().square().sum() for l in util.leaves(tree)]
    if not sq:
        return torch.zeros(())
    tot = sq[0]
    for s in sq[1:]:
        tot = tot + s
    return torch.sqrt(tot)


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return util.tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), n


class AdamW:
    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 clip_norm: Optional[float] = None):
        self.lr = lr if callable(lr) else constant_schedule(lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamState(step=torch.zeros((), dtype=torch.int32),
                         m=util.tree_map(zeros, params),
                         v=util.tree_map(zeros, params))

    def update(self, grads, state: AdamState, params):
        if self.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        lr = self.lr(state.step)
        bc1 = 1 - _f32(b1) ** step.float()
        bc2 = 1 - _f32(b2) ** step.float()

        def upd(g, m, v, p):
            gf = g.float()
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.detach().float() - lr * u).to(p.dtype), m2, v2

        out = util.tree_map(upd, grads, state.m, state.v, params)
        new_p, new_m, new_v = (util.tree_map(lambda o: o[i], out)
                               for i in range(3))
        return new_p, AdamState(step, new_m, new_v), {"grad_norm": gnorm,
                                                       "lr": lr}
