"""Crash-safe progress journal of the quantization pipeline, the port of
``repro.checkpoint.journal`` (same files, same lines, same checks: a
journal written by either package resumes in the other).

Layout under one journal directory::

    <dir>/journal.jsonl        # header line + one line per finished block
    <dir>/blocks/step_<bi>/    # the block's packed leaves (keyed
                               # CheckpointManager checkpoint, per-leaf crc32)

Every journal line is ``{"payload": {...}, "crc": crc32(canonical
payload)}`` and is flushed and fsynced on append. The header carries a
fingerprint of (model config, quant config, params, calibration data), so
a journal is never resumed against a different run: resume refuses a
mismatch.

A block is saved first and its line appended after: a crash between the
two leaves an orphan block checkpoint that resume redoes (bit-identical,
every block's draws being named by its index). The only tolerated damage
is a torn final append (a truncated last line with no newline), what a
crash mid-append leaves: it is dropped and the block redone. Any other
damage (an interior line that does not parse, a crc mismatch on a
complete line, an entry whose block checkpoint is missing or whose leaf
crcs disagree) raises :class:`JournalError` naming the block.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import (PACKED_WORDS, CheckpointManager,
                                            _fsync_path)

JOURNAL_NAME = "journal.jsonl"
JOURNAL_VERSION = 1

# JAX's default (32-bit) types of the wider ones: the calibration tokens
# are int64 tensors in the port and int32 arrays in the JAX package
_CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32}


class JournalError(RuntimeError):
    """Unresumable journal state (fingerprint mismatch or corruption).
    ``block`` names the offending block's label when the damage belongs
    to one block's entry or checkpoint."""

    def __init__(self, message: str, block: Optional[str] = None):
        self.block = block
        super().__init__(message)


def _canonical(payload: Dict[str, Any]) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _leaf_bytes(t: torch.Tensor, packed: bool):
    """(shape, dtype name, array of the raw bytes) of one tensor as the
    JAX package holds it: int64 / float64 as their 32-bit types, bfloat16
    as its 16-bit words under the name ``bfloat16``, packed words as
    uint32."""
    t = t.detach()
    t = t.to(_CANONICAL.get(t.dtype, t.dtype)).contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy()
    arr = t.numpy()
    if packed and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr.shape, arr.dtype.name, arr


def _walk(tree, packed=False):
    """Tensor leaves in ``jax.tree.leaves`` order (dict keys sorted, lists
    in order), each with whether it holds packed words."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], k in PACKED_WORDS)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    elif tree is not None:
        yield tree, packed


def _crc_leaves(tree) -> int:
    """One crc32 over every leaf's shape, dtype name and bytes (a tree of
    dicts and lists of tensors), in the JAX package's leaf order and
    types: equal to its ``_crc_leaves`` of the same values."""
    crc = 0
    for leaf, packed in _walk(tree):
        shape, name, arr = _leaf_bytes(leaf, packed)
        crc = zlib.crc32(repr((tuple(int(s) for s in shape), name)).encode(),
                         crc)
        crc = zlib.crc32(np.ascontiguousarray(arr), crc)     # read in place
    return crc


def run_fingerprint(params, cfg, qcfg, calib_batches,
                    n_blocks: int) -> Dict[str, Any]:
    """Identity of a quantization run: resume refuses any mismatch."""
    fp = {
        "version": JOURNAL_VERSION,
        "model_config": dataclasses.asdict(cfg),
        "quant_config": dataclasses.asdict(qcfg),
        "params_crc": _crc_leaves(params),
        "calib_crc": _crc_leaves(calib_batches),
        "n_blocks": n_blocks,
    }
    # canonicalized through json, so tuples compare equal to what a
    # reloaded header holds
    return json.loads(_canonical(fp))


class QuantJournal:
    """Per-block progress journal and block-leaf store (see module doc)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, JOURNAL_NAME)
        self.blocks = CheckpointManager(
            os.path.join(directory, "blocks"), keep=10 ** 9)

    # ---- writing -----------------------------------------------------------

    def _append(self, payload: Dict[str, Any]) -> None:
        line = json.dumps(
            {"payload": payload,
             "crc": zlib.crc32(_canonical(payload))}) + "\n"
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(self.dir)

    def start(self, fingerprint: Dict[str, Any]) -> None:
        """Begin a fresh journal (truncates any previous one)."""
        if os.path.exists(self.path):
            os.remove(self.path)
        self._append({"kind": "header", "fingerprint": fingerprint})

    def save_block(self, bi: int, block: str, packed_bp) -> Dict[str, Any]:
        """Persist one finished block's packed leaves (atomic, keyed).
        Returns the leaf-crc list its entry must carry."""
        self.blocks.save(bi, packed_bp, keyed=True)
        return {"leaf_crcs": self.blocks.meta(bi)["checksums"]}

    def append_block(self, payload: Dict[str, Any]) -> None:
        """Record a finished block (after :meth:`save_block`)."""
        self._append(dict(payload, kind="block"))

    def load_block(self, bi: int):
        """The block's packed leaves as CPU tensors."""
        return self.blocks.restore_keyed(bi)

    # ---- reading / resume --------------------------------------------------

    def _read_lines(self):
        """Parse the journal's lines; tolerates exactly one torn final
        append, truncating the file back to the valid prefix so that new
        appends do not run into it."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            raw = f.read()
        out, offset, i = [], 0, 0
        while offset < len(raw):
            nl = raw.find(b"\n", offset)
            complete = nl != -1
            line = raw[offset:nl] if complete else raw[offset:]
            if line == b"" and complete:
                offset = nl + 1
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
                payload, crc = rec["payload"], rec["crc"]
            except (ValueError, KeyError, TypeError, UnicodeDecodeError):
                rec = None
            if rec is None or not complete:
                rest = raw[nl + 1:] if complete else b""
                if rest.strip() == b"":
                    # torn final append: drop it and truncate the file so
                    # that the redone block appends cleanly
                    with open(self.path, "r+b") as f:
                        f.truncate(offset)
                        f.flush()
                        os.fsync(f.fileno())
                    break
                raise JournalError(
                    f"journal {self.path!r}: line {i} is corrupt and is "
                    f"not a torn final append — refusing to resume "
                    f"(delete the journal directory to start over)")
            if crc != zlib.crc32(_canonical(payload)):
                blk = payload.get("block")
                raise JournalError(
                    f"journal {self.path!r}: line {i}"
                    + (f" (block {blk!r})" if blk else "")
                    + " fails its crc32 — journal entry corrupt; "
                    "refusing to resume", block=blk)
            out.append(payload)
            offset = nl + 1
            i += 1
        return out

    def entries_for_resume(
            self, fingerprint: Dict[str, Any]) -> Optional[Dict[int, dict]]:
        """Validate the journal against `fingerprint` and every block
        entry against its block checkpoint. Returns {bi: entry} of the
        completed blocks, or None when there is no journal yet (a fresh
        start). Raises :class:`JournalError` on any mismatch."""
        lines = self._read_lines()
        if not lines:
            return None
        head = lines[0]
        if head.get("kind") != "header":
            raise JournalError(
                f"journal {self.path!r}: first line is not a header")
        if head.get("fingerprint") != fingerprint:
            theirs, ours = head.get("fingerprint") or {}, fingerprint
            diffs = [k for k in ours
                     if theirs.get(k) != ours[k]] or ["<structure>"]
            raise JournalError(
                f"journal {self.path!r} belongs to a different run "
                f"(mismatched: {', '.join(diffs)}) — refusing to resume "
                f"a journal against a different model/config/calibration")
        done: Dict[int, dict] = {}
        for entry in lines[1:]:
            if entry.get("kind") != "block":
                continue
            bi, blk = entry["bi"], entry.get("block")
            try:
                meta = self.blocks.meta(bi)
            except (OSError, ValueError) as e:
                raise JournalError(
                    f"journal entry for block {blk!r} (bi={bi}) has no "
                    f"readable block checkpoint: {e}", block=blk) from e
            if meta.get("checksums") != entry.get("leaf_crcs"):
                raise JournalError(
                    f"block {blk!r} (bi={bi}): journal leaf crc32s "
                    f"disagree with the block checkpoint — refusing to "
                    f"resume from a corrupt block entry", block=blk)
            done[bi] = entry
        # the entries must form a contiguous prefix of the block order
        for j in range(len(done)):
            if j not in done:
                raise JournalError(
                    f"journal {self.path!r}: completed blocks are not a "
                    f"contiguous prefix (missing bi={j})")
        return done

    def n_completed_blocks(self) -> int:
        """Completed blocks without full validation (whether a crash
        drill already ran)."""
        try:
            return sum(1 for p in self._read_lines()
                       if p.get("kind") == "block")
        except JournalError:
            return 0
