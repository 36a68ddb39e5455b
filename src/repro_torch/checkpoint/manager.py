"""Atomic checkpoints in the JAX package's layout: the port of the save,
restore and keyed save / restore of ``repro.checkpoint.manager`` for
parameter trees and training states.

Layout written by the JAX package: ``<dir>/step_00000123/{arrays-<k>.npz,
meta.json}``. Leaves are stored in the order JAX flattens the tree (dict
keys sorted at every level, tuple and NamedTuple items in order),
striped across numbered npz shards as ``leaf_000000``...; ``meta.json``
records each leaf's shape, dtype name and crc32 (and, for a keyed save,
each leaf's key path joined by ``/``).
Extended floats (bfloat16) are stored as same-width unsigned bit views;
packed words (int32 in the port) as uint32. A restore verifies every leaf
against ``meta.json`` and names the bad leaf on a missing shard or leaf, a
shape mismatch or a checksum mismatch. numpy reads and writes the shards;
leaves come back as CPU tensors.

A save is written into ``<dir>/.tmp-<step>-<pid>``, every file flushed and
fsynced, and the directory renamed into place with directory fsyncs
around the rename, so neither a reader nor a crash (or a power loss) ever
sees a partial step. ``keep`` bounds the steps kept; the sweep after a
save also removes the temporary directories of crashed saves.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.convert import numpy_from_tensor, tensor_from_numpy

SHARD_BYTES = 512 << 20        # leaves striped into npz shards of ~this size
# the leaves of a packed linear that hold its ±1 words (uint32 on disk)
PACKED_WORDS = frozenset({"qv", "qu_t"})


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (a directory's fsync commits its
    entries: a rename alone is not durable across a power loss)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _is_spec(node) -> bool:
    return hasattr(node, "shape") and hasattr(node, "dtype")


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in ``jax.tree.leaves`` order: a dict's keys
    sorted, a tuple's or list's items in order, a NamedTuple's fields in
    declaration order (a training state ``(params, AdamState(step, m, v),
    eff)`` flattens as JAX's does). A tuple item's path component is its
    index, a NamedTuple field's its name. Anything with a shape and a
    dtype (a tensor, an array, a ``LeafSpec``) is a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        names = getattr(tree, "_fields", None) or \
            [str(i) for i in range(len(tree))]
        out = []
        for name, item in zip(names, tree):
            out += _flatten(item, prefix + (name,))
        return out
    return [(prefix, tree)]


def _unflatten(items) -> Dict:
    out: Dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _unflatten_like(template, leaves):
    """`leaves` (in :func:`_flatten` order) in the structure of
    `template`: dicts, tuples, lists and NamedTuples rebuilt as such."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)) and not _is_spec(node):
            items = [build(x) for x in node]
            if hasattr(node, "_fields"):
                return type(node)(*items)
            return type(node)(items)
        return next(it)
    return build(template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        """The saved steps, ascending (none while the directory does not
        exist: the first save makes it)."""
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def meta(self, step: int) -> dict:
        """The saved meta.json of `step` (shapes, dtypes, per-leaf crc32s):
        integrity checks without loading arrays."""
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

    # ---- save --------------------------------------------------------------

    def save(self, step: int, tree: Any, template: Any = None,
             keyed: bool = False) -> str:
        """Write `tree` (nested dicts, tuples and NamedTuples of tensors)
        as step `step`, in the layout and leaf order the JAX package writes
        and reads. A leaf
        stored as uint32 (packed words, int32 in the port) is one whose
        `template` spec says ``uint32``, or without a template one named
        ``qv`` / ``qu_t``. With ``keyed=True`` meta.json also records each
        leaf's key path, so :meth:`restore_keyed` (and the JAX package's)
        rebuilds the tree without a template. Durable and atomic. Returns
        the step directory."""
        flat = _flatten(tree)
        if template is not None:
            specs = _flatten(template)
            if [p for p, _ in flat] != [p for p, _ in specs]:
                raise ValueError("tree and template differ in structure")
            words = [str(s.dtype) == "uint32" for _, s in specs]
        else:
            words = [bool(p) and p[-1] in PACKED_WORDS for p, _ in flat]
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shards, cur, cur_bytes = [], {}, 0
        shapes, dtypes, checksums = [], [], []
        for i, ((_, leaf), word) in enumerate(zip(flat, words)):
            arr, name = numpy_from_tensor(leaf, "uint32" if word else None)
            shapes.append(list(arr.shape))
            dtypes.append(name)
            # the crc32 of the stored bytes, read in place (no copy)
            checksums.append(zlib.crc32(np.ascontiguousarray(arr)))
            cur[f"leaf_{i:06d}"] = arr
            cur_bytes += arr.nbytes
            if cur_bytes >= SHARD_BYTES:
                shards.append(cur)
                cur, cur_bytes = {}, 0
        if cur:
            shards.append(cur)
        for k, shard in enumerate(shards):
            with open(os.path.join(tmp, f"arrays-{k}.npz"), "wb") as f:
                np.savez(f, **shard)
                f.flush()
                os.fsync(f.fileno())
        meta = {"step": step, "n_leaves": len(flat), "n_shards": len(shards),
                "shapes": shapes, "dtypes": dtypes, "checksums": checksums}
        if keyed:
            meta["keypaths"] = ["/".join(p) for p, _ in flat]
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                       # the atomic commit
        _fsync_path(self.dir)
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for name in os.listdir(self.dir):            # crashed saves
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # ---- restore -----------------------------------------------------------

    def _leaves(self, step: int, meta: dict, names: List[str]) -> List:
        """The stored leaves of `step`, each verified against meta.json
        (shard present, leaf present, shape, crc32), as CPU tensors.
        `names` names each leaf in the errors."""
        d = self._step_dir(step)
        arrays: dict = {}
        for k in range(meta["n_shards"]):
            shard_path = os.path.join(d, f"arrays-{k}.npz")
            if not os.path.exists(shard_path):
                raise ValueError(f"corrupt/truncated checkpoint {d!r}: shard "
                                 f"arrays-{k}.npz missing")
            with np.load(shard_path) as z:
                arrays.update({n: z[n] for n in z.files})
        checksums = meta.get("checksums")  # absent in pre-crc artifacts
        shapes = meta.get("shapes")
        out = []
        for i, name in enumerate(names):
            where = f"leaf {i} ({name})"
            key = f"leaf_{i:06d}"
            if key not in arrays:
                raise ValueError(f"corrupt/truncated checkpoint {d!r}: "
                                 f"{where} missing from its shard")
            raw = arrays[key]
            if shapes is not None and tuple(raw.shape) != tuple(shapes[i]):
                raise ValueError(
                    f"corrupt/truncated checkpoint {d!r}: {where} has stored "
                    f"shape {tuple(raw.shape)}, meta.json says "
                    f"{tuple(shapes[i])}")
            if checksums is not None:
                got = zlib.crc32(np.ascontiguousarray(raw))
                if got != checksums[i]:
                    raise ValueError(
                        f"corrupt/truncated checkpoint {d!r}: {where} "
                        f"checksum mismatch (stored crc32 "
                        f"{checksums[i]:#010x}, loaded {got:#010x})")
            out.append(tensor_from_numpy(raw, meta["dtypes"][i]))
        return out

    def restore(self, step: int, template: Any) -> Any:
        """Load `step` into the structure of `template` (nested dicts,
        tuples and NamedTuples whose leaves carry ``.shape``). Returns that
        structure of CPU tensors, bit-exact (packed uint32 words as
        int32)."""
        meta = self.meta(step)
        flat = _flatten(template)
        if meta["n_leaves"] != len(flat):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template has "
                f"{len(flat)} — structure mismatch")
        leaves = self._leaves(step, meta, ["/".join(p) for p, _ in flat])
        for i, ((path, spec), leaf) in enumerate(zip(flat, leaves)):
            if tuple(leaf.shape) != tuple(spec.shape):
                raise ValueError(f"leaf {i} ({'/'.join(path)}): checkpoint "
                                 f"shape {tuple(leaf.shape)} != template "
                                 f"{tuple(spec.shape)}")
        return _unflatten_like(template, leaves)

    def restore_keyed(self, step: int) -> Dict:
        """Template-free restore of a checkpoint written with
        ``save(..., keyed=True)`` (by either package): the nested dict
        rebuilt from the recorded key paths, with the same per-leaf
        checks as :meth:`restore`."""
        meta = self.meta(step)
        keypaths = meta.get("keypaths")
        if keypaths is None:
            raise ValueError(
                f"checkpoint {self._step_dir(step)!r} was not saved keyed "
                f"(no keypaths in meta) — use restore(template=...)")
        leaves = self._leaves(step, meta, keypaths)
        return _unflatten([(tuple(kp.split("/")), l)
                           for kp, l in zip(keypaths, leaves)])

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, template)
