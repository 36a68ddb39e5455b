"""Slot scheduling for the continuous-batching engine, the port of
``repro.serve.scheduler``: the host-side bookkeeping of which request
occupies which decode slot and what is still queued, the prompt-length
buckets, the preemption victim policy, and the per-slot cache ops of a
rectangular cache (the engine's cache without a pool: the attention
rectangles, the hybrid's ring of ``win`` rows, the VLM's image K/V and
the SSM family's recurrent state).

Admission policies: ``"continuous"`` refills any freed slot at once (the
default); ``"wave"`` admits a new batch only once every slot is free.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import lead_axes

ADMISSION_POLICIES = ("continuous", "wave")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                # (S,) token ids, or (S, K) frames
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    output: Optional[np.ndarray] = None
    # seconds from submit(); None = no deadline. The engine expires the
    # request (terminal status "expired") at the first tick boundary past
    # it, queued or mid-decode.
    deadline_s: Optional[float] = None


def bucket_length(n: int, max_len: int, floor: int = 8) -> int:
    """Smallest power-of-two bucket >= n (floored, capped at max_len)."""
    b = max(floor, 1)
    while b < n:
        b <<= 1
    return max(min(b, max_len), n)


def pick_preemption_victim(candidates: List[Tuple[int, int, int]]) -> int:
    """Given ``(slot, recompute_cost, admission_step)`` for every active
    slot, pick the one whose eviction wastes the least work (minimum
    recompute cost); ties break youngest-first (largest admission step,
    then slot)."""
    if not candidates:
        raise ValueError("no active slot to preempt")
    return min(candidates, key=lambda t: (t[1], -t[2], -t[0]))[0]


def cache_insert_slot(pool, single, slot: int):
    """Insert a batch-1 cache into slot `slot` of a rectangular per-slot
    cache, in place, as the reference's ``cache_insert_slot`` does, leaf
    by leaf at its stack's batch axis (``transformer.lead_axes``: 2 for
    the VLM's self layers, 1 for every other stack): the leading rows of
    an attention rectangle (all ``max_len`` of a prefill cache, its pad
    rows past the prompt too), the hybrid's whole ring of ``win`` rows,
    the VLM's image K/V, or the whole of an SSM state leaf (the f32
    ``ssm`` state and every row of each conv ring, whose short-prompt
    tail the prefill right-aligns behind zeros, so no row of the previous
    occupant survives). A paged pool takes ``paging.paged_insert_slot``."""
    for stack, leaves in pool.items():
        ax = lead_axes(stack)
        for name, leaf in leaves.items():
            src = single[stack][name]
            idx = (slice(None),) * ax + (slice(slot, slot + 1),
                                         slice(0, src.shape[ax + 1]))
            leaf[idx] = src.to(leaf.dtype)
    return pool


def cache_select_active(new, old, active):
    """Per-slot select over every leaf of a rectangular cache (the
    reference's): active slots take the freshly written cache, the others
    keep their old entries. The engine's decode commits the SSM state this
    way, layer by layer (``transformer._commit_state``); its attention
    rows need no select, as an inactive slot's write is made again, equal,
    before each read of its rows, and a slot's rows are replaced whole at
    admission. A paged pool takes ``paging.paged_select_active``."""
    out = {}
    for stack, leaves in new.items():
        ax = lead_axes(stack)
        sel = {}
        for name, n in leaves.items():
            shape = [1] * n.dim()
            shape[ax] = -1
            sel[name] = torch.where(active.reshape(shape), n,
                                    old[stack][name])
        out[stack] = sel
    return out


class SlotScheduler:
    """A queue of pending requests and a fixed pool of slots."""

    def __init__(self, n_slots: int, admission: str = "continuous"):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        self.n_slots = n_slots
        self.admission = admission
        self.slots: List[Optional[int]] = [None] * n_slots  # uid per slot
        self.pending: Deque = deque()

    def submit(self, item) -> None:
        self.pending.append(item)

    def requeue(self, item) -> None:
        """Return a preempted item to the *front* of the queue."""
        self.pending.appendleft(item)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self.free_slots())

    def admit_batch(self, gate=None) -> List[Tuple[int, object]]:
        """Pair pending requests with free slots per the admission
        policy, marking those slots occupied. `gate(item) -> bool` is a
        resource check (free pages); admission stops at the first
        gated-out item, so the head of the queue is never starved."""
        free = self.free_slots()
        if not self.pending or not free:
            return []
        if self.admission == "wave" and len(free) != self.n_slots:
            return []
        out = []
        for slot in free:
            if not self.pending:
                break
            if gate is not None and not gate(self.pending[0]):
                break
            item = self.pending.popleft()
            self.slots[slot] = getattr(item, "uid", -1)
            out.append((slot, item))
        return out

    def reap(self, should_drop) -> List[object]:
        """Remove the queued items for which ``should_drop(item)`` is true
        (cancelled or past their deadline) and return them; the survivors
        keep their order. Queued items own no pages, so the engine only
        finalizes the dropped handles."""
        dropped = [it for it in self.pending if should_drop(it)]
        if dropped:
            self.pending = deque(it for it in self.pending
                                 if not should_drop(it))
        return dropped

    def release(self, slot: int) -> None:
        self.slots[slot] = None
