"""Training loop, the port of ``repro.train.loop``: a train step with
microbatch gradient accumulation and optional binary low-rank gradient
compression with error feedback, and the ``Trainer`` host loop with
periodic atomic checkpoints and a deterministic resume.

The step is PyTorch autograd over ``models.transformer.loss_fn(...,
training=True)`` (rematerialized per layer where the config asks for it)
followed by the functional AdamW of ``train.optim``, as the reference's
is ``jax.value_and_grad`` then its AdamW. Its state ``(params,
AdamState(step, m, v), eff)`` is a tree of tensors that
``checkpoint.CheckpointManager`` saves in the JAX package's layout, so a
checkpoint of either package's ``Trainer`` resumes in the other's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import util
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.grad_compress import (CompressConfig,
                                             compress_with_error_feedback)
from repro_torch.train.optim import AdamState, AdamW, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    grad_accum: int = 1
    compress_grads: bool = False
    compress_rank: int = 4
    seed: int = 0


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(cosine_schedule(tcfg.lr, tcfg.total_steps, tcfg.warmup),
                 weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)


def _value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, gradient tree) of ``loss_fn(training=True)``; a gradient has
    its parameter's dtype, and a parameter the loss does not reach gets
    zeros (as ``jax.grad`` gives)."""
    leaves = []

    def arm(leaf):
        leaves.append(leaf.detach().requires_grad_(True))
        return leaves[-1]
    loss = T.loss_fn(util.tree_map(arm, params), cfg, batch, training=True)
    grads = iter([torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    return loss.detach(), util.tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    opt: Optional[AdamW] = None) -> Callable:
    """(params, opt_state, eff, batch) -> (params, opt_state, eff,
    metrics).

    With ``grad_accum`` > 1 the batch arrives pre-split as (accum, micro,
    ...) and the step loops over its leading axis, summing the gradients
    in f32 and averaging them and the loss; compression (when on) applies
    to the accumulated gradient with the persistent error feedback
    `eff`."""
    opt = opt or make_optimizer(tcfg)
    ccfg = CompressConfig(rank=tcfg.compress_rank)
    accum = max(1, tcfg.grad_accum)

    def train_step(params, opt_state, eff, batch):
        if accum == 1:
            loss, grads = _value_and_grad(cfg, params, batch)
        else:
            lead = next(iter(batch.values())).shape[0]
            if lead != accum:
                raise ValueError(f"grad_accum={accum} takes a batch "
                                 f"pre-split as ({accum}, micro, ...); its "
                                 f"leading axis is {lead}")
            dev = util.leaves(params)[0].device
            loss = torch.zeros((), device=dev)
            grads = util.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(accum):
                l, g = _value_and_grad(cfg, params,
                                       {k: v[i] for k, v in batch.items()})
                loss = loss + l
                grads = util.tree_map(lambda a, b: a + b.float(), grads, g)
            loss = loss / accum
            grads = util.tree_map(lambda g: g / accum, grads)

        if tcfg.compress_grads:
            grads, eff = compress_with_error_feedback(grads, eff, ccfg)

        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, eff, {"loss": loss, **om}

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> Tuple[Any, AdamState, Any]:
    """(params, opt_state, eff): the teacher drawn by
    ``models.transformer.init_params`` (from `generator`, by default one
    on `device` seeded with ``tcfg.seed``), AdamW's zero moments, and the
    error-feedback tree (zeros) when compression is on, else a 0-d f32
    placeholder."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = T.init_params(cfg, generator, device)
    opt_state = make_optimizer(tcfg).init(params)
    if tcfg.compress_grads:
        eff = util.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    else:
        eff = torch.zeros((), device=device)
    return params, opt_state, eff


def place_state(state, device):
    """A training state (a restored one's leaves are CPU tensors) on
    `device`; AdamW's step stays a CPU scalar."""
    params, opt_state, eff = state
    move = lambda t: t.to(device)  # noqa: E731
    return (util.tree_map(move, params),
            AdamState(opt_state.step.cpu(), util.tree_map(move, opt_state.m),
                      util.tree_map(move, opt_state.v)),
            util.tree_map(move, eff))


class Trainer:
    """Host loop: step the train step, checkpoint every `ckpt_every`
    steps, resume from the manager's latest step (the data iterator is
    the caller's, started at that step; see launch/train.py and
    launch/supervisor.py). `step_fn` takes the place of the reference's
    ``jit_step`` (a train step of :func:`make_train_step`'s signature)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data_iter,
                 checkpoint_mgr=None, ckpt_every: int = 100,
                 step_fn: Optional[Callable] = None, log_every: int = 10,
                 log_fn=print, device="cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        self.data_iter = data_iter
        self.ckpt_mgr = checkpoint_mgr
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self.device = resolve_device(device)
        self.step_fn = step_fn or make_train_step(cfg, tcfg)
        self.state: Optional[tuple] = None
        self.step = 0

    def restore_or_init(self):
        state0 = init_train_state(self.cfg, self.tcfg, device=self.device)
        if self.ckpt_mgr is not None:
            restored = self.ckpt_mgr.restore_latest(template=state0)
            if restored is not None:
                self.step, state = restored
                self.state = place_state(state, self.device)
                self.log(f"[trainer] resumed at step {self.step}")
                return
        self.state = state0
        self.step = 0

    def run(self, n_steps: int) -> Dict[str, float]:
        """`n_steps` steps; the last step's metrics ({} when none ran)."""
        if self.state is None:
            self.restore_or_init()
        params, opt_state, eff = self.state
        m: Dict[str, Any] = {}
        t0 = time.time()
        for _ in range(n_steps):
            batch = {k: v.to(self.device)
                     for k, v in next(self.data_iter).items()}
            params, opt_state, eff, m = self.step_fn(
                params, opt_state, eff, batch)
            self.step += 1
            if self.step % self.log_every == 0:
                last = {k: float(v) for k, v in m.items()}
                self.log(f"[trainer] step={self.step} "
                         f"loss={last.get('loss', float('nan')):.4f} "
                         f"({(time.time() - t0) / self.log_every:.2f}s/step)")
                t0 = time.time()
            if (self.ckpt_mgr is not None
                    and self.step % self.ckpt_every == 0):
                self.state = (params, opt_state, eff)
                self.ckpt_mgr.save(self.step, self.state)
        self.state = (params, opt_state, eff)
        return {k: float(v) for k, v in m.items()}
