"""Slot scheduling for the continuous-batching engine, the port of
``repro.serve.scheduler``: the host-side bookkeeping of which request
occupies which decode slot and what is still queued, the prompt-length
buckets, the preemption victim policy, and the rectangular slot cache ops.

Admission policies: ``"continuous"`` refills any freed slot at once (the
default); ``"wave"`` admits a new batch only once every slot is free.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

ADMISSION_POLICIES = ("continuous", "wave")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                # (S,) token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    output: Optional[np.ndarray] = None


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
    """Insert a batch-1 rectangular cache into slot `slot` of a pooled
    rectangular cache (batch axis 1 of every leaf), in place."""
    for name, leaf in pool["layers"].items():
        src = single["layers"][name]
        leaf[:, slot:slot + 1, :src.shape[2]] = src.to(leaf.dtype)
    return pool


def cache_select_active(new, old, active):
    """Per-slot select: active slots take the freshly written cache,
    the others keep their old entries."""
    out = {}
    for name, n in new["layers"].items():
        shape = [1] * n.dim()
        shape[1] = -1
        out[name] = torch.where(active.reshape(shape), n, old["layers"][name])
    return {"layers": out}


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

    def release(self, slot: int) -> None:
        self.slots[slot] = None
