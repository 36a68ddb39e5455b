"""Deterministic fault injection for the quantization pipeline, the port
of ``repro.quant.faults``.

The quant-side sibling of ``serve.faults.FaultPlan``: a
:class:`QuantFaultPlan` is a schedule of :class:`QuantFault` records
keyed off the pipeline's own block index — no wall clock, no ambient
randomness — that ``core.pipeline.nanoquant_quantize`` consults at its
seams. A chaos run is bit-for-bit reproducible from the plan: a killed
and resumed run gives the artifact of an uninterrupted one, and a
diverged block walks the init-method fallback ladder.

Fault kinds:

- ``"crash_block"`` — raise :class:`InjectedPipelineCrash` when block
  ``block`` *starts being computed* (a resumed/skipped block does not
  crash, so a supervised restart makes progress).
- ``"crash_after_save"`` — crash after block ``block``'s packed leaves
  are checkpointed but *before* its journal entry is appended (the
  orphan-checkpoint window: resume must redo the block, bit-identical).
- ``"crash_after_journal"`` — crash after block ``block``'s journal
  entry is appended (the clean window: resume must skip the block).
- ``"nan_init"`` — overwrite block ``block``, linear ``linear``'s init
  latents with NaN, as if ADMM had diverged at iteration
  ``iteration`` — the pipeline's health guard must catch it and walk
  the init-method fallback ladder instead of packing poison.
- ``"corrupt_journal"`` — after appending block ``block``'s journal
  entry, flip a digit inside the stored line (still valid JSON, crc now
  wrong): a later resume must refuse, naming the block.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

KINDS = ("crash_block", "crash_after_save", "crash_after_journal",
         "nan_init", "corrupt_journal")


class InjectedPipelineCrash(RuntimeError):
    """Simulated hard crash (process death stand-in) raised at a
    pipeline seam; drivers/tests catch it, then resume from the
    journal."""

    def __init__(self, block: int, seam: str):
        super().__init__(f"injected pipeline crash at block {block} "
                         f"({seam})")
        self.block = block
        self.seam = seam


@dataclasses.dataclass(frozen=True)
class QuantFault:
    """One scheduled fault (each fires at most once)."""
    block: int
    kind: str
    linear: int = 0                    # nan_init: linear index in block
    iteration: int = 0                 # nan_init: reported ADMM iteration

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown quant fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class QuantFaultPlan:
    """Deterministic schedule of :class:`QuantFault` records plus the
    replay log (``plan.fired``) two identically-planned runs must agree
    on. Pass to ``nanoquant_quantize(..., faults=plan)`` (or
    ``NanoQuantModel.quantize``; ``launch.quantize --crash-at-block``)."""

    def __init__(self, faults: Sequence[QuantFault]):
        self.faults = list(faults)
        self._spent = [False] * len(self.faults)
        self.fired: List[Tuple[int, str]] = []

    def _due(self, kind: str, block: int):
        for i, f in enumerate(self.faults):
            if not self._spent[i] and f.kind == kind and f.block == block:
                yield i, f

    def _fire(self, i: int) -> None:
        self._spent[i] = True
        f = self.faults[i]
        self.fired.append((f.block, f.kind))

    # ---- pipeline seams ----------------------------------------------------

    def on_block_start(self, bi: int) -> None:
        """Block `bi` is about to be *computed* (not resumed)."""
        for i, _ in self._due("crash_block", bi):
            self._fire(i)
            raise InjectedPipelineCrash(bi, "block start")

    def poison_init(self, bi: int, li: int) -> Optional[QuantFault]:
        """Non-None => overwrite this (block, linear)'s init latents
        with NaN (returns the fault for its reported iteration)."""
        for i, f in self._due("nan_init", bi):
            if f.linear == li:
                self._fire(i)
                return f
        return None

    def after_block_save(self, bi: int) -> None:
        """Between a block's leaf checkpoint and its journal append."""
        for i, _ in self._due("crash_after_save", bi):
            self._fire(i)
            raise InjectedPipelineCrash(bi, "after block save")

    def on_journal_append(self, bi: int, journal) -> None:
        """Right after a block's journal entry is appended: corrupt it
        and/or crash."""
        for i, _ in self._due("corrupt_journal", bi):
            self._fire(i)
            _corrupt_last_line(journal.path)
        for i, _ in self._due("crash_after_journal", bi):
            self._fire(i)
            raise InjectedPipelineCrash(bi, "after journal append")

    # ---- reporting --------------------------------------------------------

    @property
    def pending_faults(self) -> int:
        return self._spent.count(False)

    def summary(self) -> dict:
        return {"scheduled": len(self.faults),
                "fired": list(self.fired),
                "unfired": [dataclasses.asdict(self.faults[i])
                            for i, s in enumerate(self._spent) if not s]}


def _corrupt_last_line(path: str) -> None:
    """Flip one digit inside the last journal line: the line stays
    complete, well-terminated JSON — only its crc32 no longer matches
    (the 'silent bitrot' class, distinct from a torn append)."""
    with open(path, "rb") as f:
        raw = f.read()
    body = raw.rstrip(b"\n")
    start = body.rfind(b"\n") + 1
    line = bytearray(raw[start:])
    for j, b in enumerate(line):
        if ord("0") <= b <= ord("9"):
            line[j] = ord("0") if b != ord("0") else ord("1")
            break
    else:
        raise RuntimeError(f"no digit to corrupt in {path!r} last line")
    with open(path, "r+b") as f:
        f.seek(start)
        f.write(bytes(line))
        f.flush()
        os.fsync(f.fileno())
