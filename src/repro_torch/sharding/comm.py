"""The collectives of tensor-parallel serving, over a mesh's process group
(``repro_torch.launch.mesh.Mesh``): the reference's ``psum`` and the
gathers GSPMD inserts, made explicit.

- :func:`all_reduce_sum` finishes a row-parallel linear and the
  vocab-parallel embedding;
- :func:`all_gather_last` assembles the vocab-parallel logits;
- :func:`broadcast_object` and :func:`check_same` carry host values.

Every rank ends with bitwise the same result: the sum of an all-reduce is
taken in rank order on every rank (gather, then an ordered sum) under
gloo, and NCCL's ring leaves every rank the same reduced chunks.

gloo takes no CUDA tensor for an all-gather, so under gloo a CUDA tensor
is staged through host memory here, explicitly (copied to the host,
exchanged, copied back), for every collective alike. That is how ranks
that share one card exchange data; NCCL exchanges device memory.

:data:`STATS` counts each collective's calls and the bytes each rank
sent, so that a run can show what crossed ranks.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

STATS: Dict[str, int] = {}


def reset_stats() -> None:
    for k in ("all_reduce", "all_gather", "broadcast", "check",
              "all_reduce_bytes", "all_gather_bytes"):
        STATS[k] = 0


reset_stats()


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` as the backend takes it: on the host under gloo."""
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def _gather(mesh, t: torch.Tensor):
    """Every rank's `t` of the mesh's model group, in rank order."""
    src = _staged(mesh, t.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.tp)]
    dist.all_gather(parts, src, group=mesh.group)
    return parts


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's `t` over the model axis (a new tensor on
    t's device, in t's dtype)."""
    STATS["all_reduce"] += 1
    STATS["all_reduce_bytes"] += t.numel() * t.element_size()
    if mesh.backend == "gloo":
        parts = _gather(mesh, t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out.to(t.device)
    out = t.contiguous().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def all_gather_last(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `t` concatenated along the last dim, in rank order."""
    STATS["all_gather"] += 1
    STATS["all_gather_bytes"] += t.numel() * t.element_size()
    return torch.cat(_gather(mesh, t), dim=-1).to(t.device)


def broadcast_object(obj: Any, mesh, src: int = 0) -> Any:
    """A picklable host object from the group's rank `src` to all."""
    STATS["broadcast"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, src)
                               if mesh.group is not None else src,
                               group=mesh.group)
    return box[0]


def fingerprint(*arrays) -> int:
    """A 31-bit digest of host arrays (their bytes, dtypes and shapes)."""
    h = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        h = zlib.crc32(repr((a.dtype.str, a.shape)).encode(), h)
        h = zlib.crc32(a.tobytes(), h)
    return h & 0x7FFFFFFF


def check_same(value: int, mesh, what: str) -> None:
    """Raise unless every rank of the model group passes the same int."""
    STATS["check"] += 1
    dev = mesh.device if mesh.backend == "nccl" else "cpu"
    got = [int(x) for x in _gather(mesh, torch.tensor(
        [value], dtype=torch.int64, device=dev))]
    if len(set(got)) != 1:
        raise RuntimeError(f"ranks left lockstep: {what} differs across "
                           f"ranks ({got})")
