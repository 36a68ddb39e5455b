"""Engine snapshot and restore (drain → snapshot → rebuild → resume), the
port of ``repro.serve.recovery``.

A snapshot is the host-side resume state only. Per unfinished request it
holds the original prompt, the tokens emitted so far, the remaining budget
and deadline. No KV page is saved: restore re-prefills prompt + emitted
through the engine's ``_Resume`` path (the form a preemption requeues),
which is token-exact under greedy decoding. A snapshot is therefore small,
valid across engine geometries (pool and page size, batch) and across
processes. Its JSON is the JAX package's, key for key, so a snapshot
written by either package restores in the other.

    done = engine.drain(timeout=30.0)      # stop admission, checkpoint
    recovery.save_snapshot(engine, path)
    ...                                    # the process may die here
    fresh = model.engine(scfg, ...)        # a new process or engine
    handles = recovery.restore(fresh, recovery.load_snapshot(path))
    fresh.run()                            # resumes token-identically

``launch/serve.py --snapshot PATH`` wires this under
``launch/supervisor.py`` for crash-restart serving.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import InferenceEngine, RequestHandle, _Resume
from repro_torch.serve.scheduler import Request

SNAPSHOT_VERSION = 1


def snapshot(engine: InferenceEngine) -> Dict[str, Any]:
    """Every unfinished request as a JSON-serializable resume record:
    active slots first (in slot order), then the queue in FIFO order, so
    that a restored engine re-admits in the order the source served.
    Call after ``drain()`` for a quiesced snapshot; a live engine is safe
    too (the records are host state), its slots captured mid-flight.
    Refused for a tensor-parallel engine: each rank would write its own
    file, and a restart restores one process (ROADMAP item 12d)."""
    if engine.mesh is not None:
        raise NotImplementedError(
            "snapshots of a tensor-parallel engine are not supported "
            "(ROADMAP item 12d)")
    items: List[Dict[str, Any]] = []

    def add(handle: RequestHandle, emitted: List[Any], budget: int):
        req = handle.request
        deadline_left = None
        if handle.deadline_at is not None:
            deadline_left = max(0.0, handle.deadline_at - engine.clock())
        items.append({
            "uid": int(req.uid),
            "prompt": np.asarray(req.prompt).tolist(),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "emitted": [np.asarray(t).tolist() for t in emitted],
            "budget": int(budget),
            "deadline_left_s": deadline_left,
        })

    for slot in np.nonzero(engine.active)[0]:
        task = engine._tasks[int(slot)]
        add(task.handle, task.toks, task.budget)
    for item in engine.scheduler.pending:
        if isinstance(item, _Resume):
            add(item.handle, item.emitted, item.budget)
        else:
            add(item, [], item.request.max_new_tokens)
    return {"version": SNAPSHOT_VERSION, "max_len": int(engine.max_len),
            "greedy": bool(engine.scfg.greedy), "items": items}


def save_snapshot(engine: InferenceEngine, path: str) -> str:
    """Snapshot to `path` atomically (a temporary file, then
    ``os.replace``): a crash mid-write leaves the previous snapshot."""
    snap = snapshot(engine)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".snap.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path) as f:
        snap = json.load(f)
    version = snap.get("version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot {path!r}: version {version} not "
                         f"supported (expected {SNAPSHOT_VERSION})")
    return snap


def restore(engine: InferenceEngine, snap: Dict[str, Any],
            on_token: Optional[Callable] = None
            ) -> Dict[int, RequestHandle]:
    """Resubmit every record of `snap` into `engine`; returns {uid:
    handle}. A record with emitted tokens enters as a ``_Resume``
    (prompt + emitted re-prefilled, the remaining budget), its tokens
    pre-buffered on the handle, so under greedy decoding the whole output
    equals that of the run the snapshot interrupted. The remaining
    deadline carries over (a lapsed one expires at the first tick).
    Raises for an engine whose max_len could not hold a resumed prompt."""
    if snap["max_len"] > engine.max_len:
        raise ValueError(
            f"snapshot needs max_len >= {snap['max_len']}, engine has "
            f"{engine.max_len}: resumed prompts could not fit")
    handles: Dict[int, RequestHandle] = {}
    for it in snap["items"]:
        prompt = np.asarray(it["prompt"], np.int64)
        req = Request(it["uid"], prompt,
                      max_new_tokens=it["max_new_tokens"],
                      eos_id=it["eos_id"],
                      deadline_s=it["deadline_left_s"])
        handle = engine.submit(req, on_token=on_token)
        # an int per token, or the audio family's (K,) frames
        emitted = [np.asarray(t, np.int64) if prompt.ndim > 1 else int(t)
                   for t in it["emitted"]]
        if emitted:
            # swap the fresh queue entry for a resume carrying the emitted
            # tokens (what a preemption requeues)
            if engine.scheduler.pending.pop() is not handle:
                raise RuntimeError("submit() no longer queues at the tail")
            engine.scheduler.submit(_Resume(
                handle, np.concatenate([prompt, np.asarray(emitted,
                                                           np.int64)]),
                it["budget"], emitted))
            for t in emitted:              # replay into the stream view
                handle._append(t)
        handles[it["uid"]] = handle
    return handles
