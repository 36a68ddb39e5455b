"""Deterministic fault injection for the serving engine, the port of
``repro.serve.faults``.

A :class:`FaultPlan` is a schedule of :class:`Fault` records (a kind, the
engine step it arms at and, where relevant, a target uid) that the engine
consults at its seams: tick boundaries (``on_step``), the admission gate
(``on_gate``), the prefill (``poison_prefill``, ``on_prefill``), the
speculative commit (``on_spec_cycle``) and the decode step
(``before_decode``). Everything is keyed on the engine's own step counter
and uids, with no wall clock and no ambient randomness, so a chaos run is
reproducible bit for bit from its plan; :meth:`FaultPlan.random` builds a
plan from a seed with the same ``numpy.random.default_rng`` draws as the
JAX package, so one seed gives one plan in both packages.

Fault kinds:

- ``"cancel"``: client cancellation at a tick boundary.
- ``"cancel_prefill"``: cancellation between the target's prefill and its
  slot activation (the admission unwind).
- ``"cancel_spec"``: cancellation inside the speculative commit cycle
  (reaped at the next tick boundary).
- ``"expire"``: the target's deadline forced into the past.
- ``"dry_pool"``: ``pages`` pages borrowed out of the pool for ``hold``
  steps (``PagedKVState.borrow_pages``): preemptions and admission
  queueing while accounting stays exact.
- ``"preempt"``: a forced preemption storm of ``pages`` (>= 1)
  cost-ranked victims this step.
- ``"evict_prefix"``: up to ``pages`` refcount-zero cached prefix pages
  evicted between the admission gate's match and ``kv.admit``.
- ``"device_error"``: :class:`InjectedDeviceError` raised just before the
  decode step's first kernel is enqueued (the recoverable class: the pool
  is intact).
- ``"poison_prefill"``: the target's prefill logits overwritten with NaN.

The pool seams (``dry_pool``, ``preempt``) fire only on an engine with a
paged pool (``eng.paged``); on the SSM family's state cache they stay
armed and unfired, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("cancel", "cancel_prefill", "cancel_spec", "expire", "dry_pool",
         "preempt", "evict_prefix", "device_error", "poison_prefill")


class InjectedDeviceError(RuntimeError):
    """Simulated device failure in the decode step, raised before any of
    the step's kernels is enqueued (``InferenceEngine._on_device_fault``).
    A real CUDA fault is sticky and is not this class."""

    def __init__(self, uid: Optional[int] = None):
        super().__init__("injected device error"
                         + (f" (attributed to request {uid})"
                            if uid is not None else ""))
        self.uid = uid


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: arms at engine step ``step`` and fires at the
    first matching seam after that (each fault fires once)."""
    step: int
    kind: str
    uid: Optional[int] = None          # target request, where relevant
    pages: int = 2                     # dry_pool / evict_prefix size,
    #                                    preempt victim count
    hold: int = 2                      # dry_pool: steps the pages stay out

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class FaultPlan:
    """A schedule of :class:`Fault` records plus the state of a chaos run
    (what fired when, pages currently borrowed). Pass it as
    ``InferenceEngine(..., faults=plan)``; ``plan.fired`` is the replay
    log two runs of one plan must agree on."""

    def __init__(self, faults: Sequence[Fault],
                 seed: Optional[int] = None):
        self.faults = sorted(faults,
                             key=lambda f: (f.step, KINDS.index(f.kind),
                                            -1 if f.uid is None else f.uid))
        self.seed = seed
        self.fired: List[Tuple[int, str, Optional[int]]] = []
        self._spent = [False] * len(self.faults)
        self._borrowed: List[Tuple[int, List[int]]] = []  # (due, pages)

    @classmethod
    def random(cls, seed: int, uids: Sequence[int], n_steps: int,
               kinds: Sequence[str] = KINDS, n_faults: int = 8,
               pages: int = 2) -> "FaultPlan":
        """Seeded random plan: `n_faults` faults over `n_steps` steps
        targeting `uids`. Same arguments => same plan."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            uid = int(uids[int(rng.integers(len(uids)))]) if uids else None
            faults.append(Fault(step=int(rng.integers(1, max(2, n_steps))),
                                kind=kind, uid=uid,
                                pages=int(rng.integers(1, pages + 1))))
        return cls(faults, seed=seed)

    # ---- internal ---------------------------------------------------------

    def _due(self, eng, kind: str, uid: Optional[int] = None):
        """Armed, unspent faults of `kind` (optionally for `uid`)."""
        step = eng.stats["steps"]
        for i, f in enumerate(self.faults):
            if self._spent[i] or f.kind != kind or f.step > step:
                continue
            if uid is not None and f.uid != uid:
                continue
            yield i, f

    def _fire(self, eng, i: int) -> None:
        f = self.faults[i]
        self._spent[i] = True
        self.fired.append((int(eng.stats["steps"]), f.kind, f.uid))

    def _handle(self, eng, uid):
        h = eng.handles.get(uid)
        return h if h is not None and not h.finished else None

    # ---- engine seams -----------------------------------------------------

    def on_step(self, eng) -> None:
        """Tick boundary, before the engine reaps: cancellations, forced
        deadline expiry, dry-pool borrow and return, preemption storms."""
        for due, pages in [b for b in self._borrowed
                           if b[0] <= eng.stats["steps"]]:
            eng.kv.return_pages(pages)
            self._borrowed.remove((due, pages))
        for i, f in list(self._due(eng, "cancel")):
            h = self._handle(eng, f.uid)
            if h is not None:
                h.cancel("fault-injected cancel")
                self._fire(eng, i)
        for i, f in list(self._due(eng, "expire")):
            h = self._handle(eng, f.uid)
            if h is not None:
                h.deadline_at = eng.clock() - 1.0   # already past
                self._fire(eng, i)
        for i, f in list(self._due(eng, "dry_pool")):
            if eng.paged:
                pages = eng.kv.borrow_pages(f.pages)
                if pages:
                    self._borrowed.append((eng.stats["steps"] + f.hold,
                                           pages))
                    self._fire(eng, i)
        for i, f in list(self._due(eng, "preempt")):
            if eng.paged and eng.active.any():
                for _ in range(max(1, f.pages)):
                    if not eng.active.any():
                        break
                    eng._preempt(eng._select_victim())
                self._fire(eng, i)

    def on_gate(self, eng) -> None:
        """Inside the admission gate, before the item's own prefix match:
        evict cached prefix pages; chains that earlier items of the batch
        protected must survive."""
        for i, f in list(self._due(eng, "evict_prefix")):
            if eng.prefix is not None:
                eng.prefix.reclaim(f.pages)
                self._fire(eng, i)

    def poison_prefill(self, eng, uid: int) -> bool:
        """True => overwrite this admission's prefill logits with NaN."""
        for i, _ in list(self._due(eng, "poison_prefill", uid)):
            self._fire(eng, i)
            return True
        return False

    def on_prefill(self, eng, handle) -> None:
        """Between a request's prefill and its slot activation."""
        for i, _ in list(self._due(eng, "cancel_prefill", handle.uid)):
            handle.cancel("fault-injected cancel mid-prefill")
            self._fire(eng, i)

    def on_spec_cycle(self, eng) -> None:
        """Inside the speculative cycle, between the host read of the
        verify's result and the per-slot commit and trim."""
        for i, f in list(self._due(eng, "cancel_spec")):
            h = self._handle(eng, f.uid)
            if h is not None:
                h.cancel("fault-injected cancel mid-spec-rollback")
                self._fire(eng, i)

    def before_decode(self, eng) -> None:
        """Just before the decode step (or speculative cycle) enqueues its
        first kernel."""
        for i, f in list(self._due(eng, "device_error")):
            self._fire(eng, i)
            raise InjectedDeviceError(f.uid)

    # ---- reporting --------------------------------------------------------

    @property
    def borrowed_pages(self) -> int:
        """Pages dry_pool faults hold out of the pool right now; a driver
        keeps ticking until this is 0 before it audits for leaks (the
        plan returns them at their due tick)."""
        return sum(len(pages) for _, pages in self._borrowed)

    def summary(self) -> dict:
        return {"seed": self.seed,
                "scheduled": len(self.faults),
                "fired": list(self.fired),
                "unfired": [dataclasses.asdict(self.faults[i])
                            for i, s in enumerate(self._spent) if not s]}
