"""Meshes of ranks for tensor-parallel serving, the port of
``repro.launch.mesh`` over ``torch.distributed``.

A :class:`Mesh` is this process's view of an initialised process group:
the axis names and sizes (``("data", "model")`` or ``("pod", "data",
"model")``, as the reference's), this rank's coordinates, the process
group of its ``model`` axis, its device and the backend. It has
``axis_names`` and ``shape`` like the reference's mesh, so
``repro_torch.sharding.rules`` reads either.

:func:`run_ranks` starts N ranks and runs a function in each: N processes
from ``torch.multiprocessing`` with a ``file://`` store in a temporary
directory (no TCP port, so several test workers can start ranks side by
side), or, under ``torchrun`` (its environment present), this process as
one rank of the group torchrun started. The backend is chosen by the
caller and never switched: ``nccl`` puts rank r on ``cuda:r`` (torchrun's
``cuda:LOCAL_RANK``) and refuses to start with fewer cards than ranks; ``gloo`` runs ranks on whatever
device the function puts them on (the CPU, or one card shared by every
rank). A rank that raises fails the call: the other ranks are stopped and
the error is raised in the caller.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# a rank that waits longer than this on a collective fails
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """axis_names / sizes: the mesh's axes; coords: this rank's index
    along each; group: the process group of the ranks that share this
    rank's coordinates on every axis but ``model`` (the tensor-parallel
    group); device: where this rank's shards live; backend: the process
    group's backend."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Dict[str, int]
    group: Any
    device: torch.device
    backend: str

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def tp(self) -> int:
        """Ranks on the ``model`` axis."""
        return self.shape.get("model", 1)

    @property
    def tp_rank(self) -> int:
        """This rank's index on the ``model`` axis."""
        return self.coords.get("model", 0)


def _default_device(backend: str) -> torch.device:
    from repro_torch import resolve_device
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % max(1, torch.cuda.device_count()))))
    return resolve_device("cuda")


def _mk(sizes: Tuple[int, ...], axes: Tuple[str, ...], device=None) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: start "
                           "the ranks with repro_torch.launch.mesh.run_ranks "
                           "(or torchrun)")
    need, world = math.prod(sizes), dist.get_world_size()
    if need != world:
        raise RuntimeError(f"mesh {dict(zip(axes, sizes))} needs {need} "
                           f"ranks, the process group has {world}")
    rank = dist.get_rank()
    coords, rest = {}, rank
    for a, n in reversed(list(zip(axes, sizes))):      # row-major
        coords[a], rest = rest % n, rest // n
    coords = {a: coords[a] for a in axes}
    n_tp = dict(zip(axes, sizes)).get("model", 1)
    if n_tp == world:
        group = dist.group.WORLD
    else:
        # one group per block of `n_tp` consecutive ranks (model is the
        # innermost axis); every rank creates every group, in order
        group = None
        for start in range(0, world, n_tp):
            g = dist.new_group(list(range(start, start + n_tp)))
            if start <= rank < start + n_tp:
                group = g
    backend = str(dist.get_backend())
    dev = torch.device(device) if device is not None \
        else _default_device(backend)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl ranks live on CUDA devices, not {dev}")
    return Mesh(tuple(axes), tuple(sizes), coords, group, dev, backend)


def make_mesh(data: int, model: int, pod: Optional[int] = None,
              device=None) -> Mesh:
    """This rank's view of a (data, model) or (pod, data, model) mesh over
    the initialised default process group (its size must be the mesh's).
    `device`: this rank's device; default ``cuda:LOCAL_RANK`` under
    nccl and the current card under gloo (pass ``"cpu"`` for CPU ranks)."""
    if pod:
        return _mk((pod, data, model), ("pod", "data", "model"), device)
    return _mk((data, model), ("data", "model"), device)


def make_serving_mesh(model: int, device=None) -> Mesh:
    """Tensor-parallel serving mesh for the InferenceEngine: one ``model``
    axis of `model` ranks (the data axis is size 1: the engine's slot pool
    is one replica)."""
    return make_mesh(1, model, device=device)


def under_torchrun() -> bool:
    """Whether this process is one rank of a group torchrun started."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def check_backend(backend: str, n: int) -> None:
    """Raise unless `backend` can start `n` ranks here: nccl needs one card
    per rank on this machine (two ranks on one card are refused by NCCL):
    all `n` under :func:`run_ranks`' own processes, torchrun's
    ``LOCAL_WORLD_SIZE`` under torchrun, whose ranks may span machines."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if backend == "nccl":
        here = int(os.environ.get("LOCAL_WORLD_SIZE", n)) \
            if under_torchrun() else n
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < here:
            raise RuntimeError(
                f"nccl puts each of the {here} ranks on this machine on a "
                f"card of its own and it has {cards}; use backend 'gloo' to "
                f"run the ranks on one device")


def _rank_main(rank: int, fn, n: int, backend: str, store: str, out: str,
               threads: Optional[int], args) -> None:
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        # every rank of run_ranks is on this host: gloo's pairs connect
        # over the loopback device, whatever the host name resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = fn(rank, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()             # no rank closes its pairs mid-collective
    finally:
        dist.destroy_process_group()
    # The interpreter's teardown can abort in gloo's C++ threads
    # ("terminate called without an active exception", about one rank in
    # ten with several groups side by side on the CPU). The result is on
    # disk and the group destroyed, so the rank leaves without it.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn: Callable, n: int, backend: str, args: tuple = (),
              workdir: Optional[str] = None,
              threads: Optional[int] = None) -> Dict[int, Any]:
    """Run ``fn(rank, *args)`` in each of `n` ranks of a new process group
    over `backend`; returns {rank: fn's picklable result}. `fn` must be
    importable by name (a module-level function); `workdir` holds the
    store and the results (a temporary directory under it, removed at the
    end); `threads` caps each rank's torch threads. Under torchrun this
    process is one rank of torchrun's group: `fn` runs here and only its
    own result is returned (a group this call initialised is destroyed
    before it returns)."""
    check_backend(backend, n)
    if under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != n:
            raise RuntimeError(f"torchrun started {os.environ['WORLD_SIZE']} "
                               f"ranks, {n} were asked for")
        rank = int(os.environ["RANK"])
        if dist.is_initialized():
            return {rank: fn(rank, *args)}
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            res = fn(rank, *args)
            dist.barrier()         # no rank closes its pairs mid-collective
        finally:
            dist.destroy_process_group()
        return {rank: res}
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="nq-ranks-", dir=workdir)
    try:
        mp.start_processes(_rank_main,
                           args=(fn, n, backend, os.path.join(tmp, "store"),
                                 tmp, threads, tuple(args)),
                           nprocs=n, join=True, start_method="spawn")
        out = {}
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out[r] = pickle.load(f)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
