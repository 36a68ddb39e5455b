"""Checkpoints in the JAX package's layout: the port of the save and
restore of ``repro.checkpoint.manager`` for parameter trees.

Layout written by the JAX package: ``<dir>/step_00000123/{arrays-<k>.npz,
meta.json}``. Leaves are stored in the order JAX flattens the parameter
dict (keys sorted at every level), striped across numbered npz shards as
``leaf_000000``...; ``meta.json`` records each leaf's shape, dtype name
and crc32. Extended floats (bfloat16) are stored as same-width unsigned
bit views. A restore verifies every leaf against ``meta.json`` and names
the bad leaf on a missing shard or leaf, a shape mismatch or a checksum
mismatch. numpy reads and writes the shards; leaves come back as CPU
tensors. A save is written into ``<dir>/.tmp-<step>-<pid>`` and renamed
into place, so a reader never sees a partial step.
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


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in JAX's dict flatten order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
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


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = directory

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
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
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

    def save(self, step: int, tree: Any, template: Any) -> str:
        """Write nested dict `tree` of tensors as step `step`, in the
        layout and leaf order the JAX package writes and reads; a leaf
        whose `template` spec says ``uint32`` (packed words, int32 in the
        port) is stored as uint32. Atomic: written beside the step and
        renamed into place. Returns the step directory."""
        flat, specs = _flatten(tree), _flatten(template)
        if [p for p, _ in flat] != [p for p, _ in specs]:
            raise ValueError("tree and template differ in structure")
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shards, cur, cur_bytes = [], {}, 0
        shapes, dtypes, checksums = [], [], []
        for i, ((_, leaf), (_, spec)) in enumerate(zip(flat, specs)):
            arr, name = numpy_from_tensor(
                leaf, "uint32" if str(spec.dtype) == "uint32" else None)
            shapes.append(list(arr.shape))
            dtypes.append(name)
            checksums.append(zlib.crc32(np.ascontiguousarray(arr).tobytes()))
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
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(flat),
                       "n_shards": len(shards), "shapes": shapes,
                       "dtypes": dtypes, "checksums": checksums}, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    def restore(self, step: int, template: Any) -> Dict:
        """Load `step` into the structure of `template` (a nested dict
        whose leaves carry ``.shape``). Returns a nested dict of CPU
        tensors, bit-exact (packed uint32 words as int32)."""
        d = self._step_dir(step)
        meta = self.meta(step)
        flat = _flatten(template)
        if meta["n_leaves"] != len(flat):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template has "
                f"{len(flat)} — structure mismatch")
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
        leaves = []
        for i, (path, spec) in enumerate(flat):
            where = f"leaf {i} ({'/'.join(path)})"
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
                got = zlib.crc32(np.ascontiguousarray(raw).tobytes())
                if got != checksums[i]:
                    raise ValueError(
                        f"corrupt/truncated checkpoint {d!r}: {where} "
                        f"checksum mismatch (stored crc32 "
                        f"{checksums[i]:#010x}, loaded {got:#010x})")
            if tuple(raw.shape) != tuple(spec.shape):
                raise ValueError(f"{where}: checkpoint shape "
                                 f"{tuple(raw.shape)} != template "
                                 f"{tuple(spec.shape)}")
            leaves.append((path, tensor_from_numpy(raw, meta["dtypes"][i])))
        return _unflatten(leaves)

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, template)
