"""Per-family partition-spec rules (DP / FSDP / TP / EP / pod axis), the
port of ``repro.sharding.rules`` as plain Python.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated). It is what ``jax.sharding.
PartitionSpec`` holds, and the rules below give the reference's specs
spec for spec. A mesh is any object with ``axis_names`` and ``shape``
(axis name -> size): ``repro_torch.launch.mesh.Mesh``, or an abstract
mesh of the reference's.

Mesh contract: axes are ``("data", "model")`` single-pod or ``("pod",
"data", "model")`` multi-pod. Policy:

- **batch** is sharded over every data-parallel axis (``pod`` + ``data``).
- **params** are FSDP-sharded over ``data`` on one dim and tensor-parallel
  over ``model`` on the other (Megatron pairing: column-parallel
  wq/wk/wv/w_gate/w_up, row-parallel wo/w_down); replicated across pods.
- **MoE experts** are expert-parallel on ``model``; the router stays
  replicated.
- **Mamba2 mixers**: the wide z/x streams are TP-sharded on ``model``;
  B/C/dt are replicated; out_proj is row-parallel.
- **Quantized linears** (packed low-rank binary) follow the Megatron
  pairing of their FP counterparts: column-parallel projections shard U
  with its s1 scale on d_out (V/s2 replicated: each rank runs the whole
  kernel on its output shard, no collective); row-parallel projections
  shard V on packed d_in with its s2 scale (U/s1 replicated: partial
  outputs finish with ONE all-reduce). ``qv_sharded`` additionally
  r-shards V on column-parallel linears (the training layout; the
  serving launch keeps V replicated, see :data:`SERVE`).
- **KV caches**: kv-head dim on ``model`` when divisible, else the
  sequence dim; batch on data axes.

Every rule checks divisibility against the mesh axis size and falls back
to None (replicated): uneven shardings are never emitted.

The reference places a tree with ``to_shardings`` and launches kernels
through ``shard_map``; neither has a PyTorch counterpart. Here each rank
holds its own shards: :func:`local_shard` cuts one rank's block of a
full tensor by its spec, :func:`local_shape` gives that block's shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]


def data_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel axes, outermost first ((pod, data) or (data,))."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The reference's knobs. ``qv_sharded`` (r-dim TP of the packed V
    factor) defaults on for training; :data:`SERVE` turns it off."""
    fsdp: bool = True              # shard params over `data` (ZeRO-3 style)
    fsdp_pod: bool = False         # extend FSDP over the pod axis too
    qv_sharded: bool = True        # shard packed V on r (beyond-paper TP)
    seq_shard_cache: bool = True   # allow sequence-sharded KV caches


DEFAULT = ShardingPolicy()

# Serving placement (InferenceEngine): tensor-parallel only. No FSDP, and
# V stays replicated so every rank runs the whole fused kernel on its
# local shard.
SERVE = ShardingPolicy(fsdp=False, qv_sharded=False)

# Megatron pairing for quantized linears, keyed on the parent linear
# name. Column-parallel: output dim sharded, input replicated.
# Row-parallel: input dim sharded, output reduced with one all-reduce.
COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up", "wz", "wx",
                "wqkv", "wgu")
ROW_PARALLEL = ("wo", "w_down", "out_proj")


def tp_role(name) -> Optional[str]:
    """'col' | 'row' | None for a linear's name. Accepts bare parent keys
    ('wo'), rule paths ('layers/attn/wo') and tap names ('attn.wo')."""
    if not name:
        return None
    leaf = str(name).replace(".", "/").rsplit("/", 1)[-1]
    if leaf in COL_PARALLEL:
        return "col"
    if leaf in ROW_PARALLEL:
        return "row"
    return None


def _fit(dim: int, axis, mesh):
    """axis if dim divides evenly over it, else None."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 \
        else None


def _none(n: int) -> Spec:
    return (None,) * n


def _norm(spec: Spec) -> Spec:
    """A one-axis tuple entry as its axis name, as ``PartitionSpec``
    stores it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _Ruler:
    def __init__(self, cfg, mesh, policy: ShardingPolicy):
        self.cfg = cfg
        self.mesh = mesh
        self.policy = policy
        self.tp = "model" if "model" in mesh.axis_names else None
        fsdp: Any = None
        if policy.fsdp and "data" in mesh.axis_names:
            fsdp = ("pod", "data") if (policy.fsdp_pod
                                       and "pod" in mesh.axis_names) else "data"
        self.fsdp = fsdp

    def _two(self, shape, a0, a1) -> Spec:
        """Spec of the trailing 2 dims; leading dims (scan axes) None."""
        return _none(len(shape) - 2) + (_fit(shape[-2], a0, self.mesh),
                                        _fit(shape[-1], a1, self.mesh))

    def _one(self, shape, a0) -> Spec:
        return _none(len(shape) - 1) + (_fit(shape[-1], a0, self.mesh),)

    def spec(self, path: str, shape) -> Spec:
        name = path.rsplit("/", 1)[-1]
        cfg, mesh = self.cfg, self.mesh
        tp, fsdp = self.tp, self.fsdp

        if len(shape) == 0:
            return ()

        # ---- quantized leaves (packed low-rank binary) --------------------
        if name in ("qu_t", "qv", "s1", "s2", "rmask"):
            base = 2 if name in ("qu_t", "qv") else 1
            lead = len(shape) - base
            spec = [None] * len(shape)
            # expert-parallel applies to true expert stacks only; a shared
            # expert's FFN takes the Megatron pairing below
            expert = ("/moe/" in path or path.startswith("moe/")) \
                and "/shared/" not in path
            parent = path.split("/")[-2] if "/" in path else ""
            role = tp_role(parent)
            if expert and lead >= 1:
                spec[lead - 1] = _fit(shape[lead - 1], tp, mesh)
            elif role == "row":
                # V/s2 shard on (packed) d_in; the s2 check mirrors qv's
                # packed dim so the pair never shards inconsistently
                if name == "qv":                  # (..., d_in//32, r)
                    spec[-2] = _fit(shape[-2], tp, mesh)
                elif name == "s2":                # (..., d_in)
                    spec[-1] = tp if tp is not None and \
                        shape[-1] % (32 * _axis_size(mesh, tp)) == 0 \
                        else None
            elif role == "col":
                if name == "qu_t":                # (..., r//32, d_out)
                    spec[-1] = _fit(shape[-1], tp, mesh)
                elif name == "qv" and self.policy.qv_sharded:
                    spec[-1] = _fit(shape[-1], tp, mesh)
                elif name == "s1":
                    spec[-1] = _fit(shape[-1], tp, mesh)
            return tuple(spec)
        # STE latents stay replicated
        if name in ("lu", "lv"):
            return _none(len(shape))

        # ---- embeddings / head --------------------------------------------
        if name == "embed":
            if cfg.family == "audio":             # (K, V, d)
                return (None, _fit(shape[-2], tp, mesh),
                        _fit(shape[-1], fsdp, mesh))
            return self._two(shape, tp, fsdp)     # (V, d)
        if "lm_head" in path and name == "w":     # (d, V)
            return self._two(shape, fsdp, tp)

        # ---- MoE -----------------------------------------------------------
        if "/moe/" in path or path.startswith("moe/"):
            if "router" in path:
                return _none(len(shape))
            if "shared" in path:                  # dense shared expert FFN
                if name == "w" and ("w_down" in path):
                    return self._two(shape, tp, fsdp)
                if name == "w":
                    return self._two(shape, fsdp, tp)
                return self._one(shape, tp) if name == "b" \
                    else _none(len(shape))
            if name == "w":                       # (..., E, d, f) experts
                ep = _fit(shape[-3], tp, mesh)
                return _none(len(shape) - 3) + (
                    ep, _fit(shape[-2], fsdp, mesh), None)

        # ---- attention (incl. MLA / cross-attn) ----------------------------
        if name == "w":
            col = any(s in path for s in
                      ("/wq/", "/wk/", "/wv/", "/w_uk/", "/w_uv/",
                       "/w_gate/", "/w_up/"))
            row = any(s in path for s in ("/wo/", "/w_down/"))
            if col:
                # MLA up-projections contract over the small lora rank;
                # only the wide output dim is TP-sharded
                a0 = fsdp if not any(s in path for s in ("/w_uk/", "/w_uv/")) \
                    else None
                return self._two(shape, a0, tp)
            if row:
                return self._two(shape, tp, fsdp)
            if any(s in path for s in ("/w_dkv/", "/w_kr/")):
                return self._two(shape, fsdp, None)
            if any(s in path for s in ("/wz/", "/wx/")):
                return self._two(shape, fsdp, tp)
            if any(s in path for s in ("/wB/", "/wC/", "/wdt/")):
                return self._two(shape, fsdp, None)
            if "out_proj" in path:                # row-parallel
                return self._two(shape, tp, fsdp)
        if name == "b":
            col = any(s in path for s in ("/wq/", "/wk/", "/wv/"))
            return self._one(shape, tp if col else None)

        # ---- mamba conv / gated-norm ride with the TP-sharded d_inner ------
        if name in ("conv_x", "conv_bx") or (name == "norm_w"
                                             and "mixer" in path):
            return self._one(shape, tp)

        # ---- everything else (norms, gates, conv, SSM params) -------------
        return _none(len(shape))


def map_with_path(fn, tree, path: str = ""):
    """fn(path, leaf) over every leaf of a tree of dicts and lists (keys
    and list indices joined by ``/``, as the reference's path strings);
    None stays None. A tuple is a leaf: a spec tree maps too."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_pspecs(cfg, params, mesh, policy: ShardingPolicy = DEFAULT):
    """Spec tree mirroring `params` (tensors, arrays or shape templates)."""
    ruler = _Ruler(cfg, mesh, policy)
    return map_with_path(lambda p, l: _norm(ruler.spec(p, _shape(l))),
                         params)


def batch_pspecs(cfg, batch, mesh, grad_accum: int = 1):
    """Batch dim -> all DP axes; everything else replicated. With
    grad_accum > 1 the leading dim is the microbatch axis (replicated)
    and the *second* dim is the sharded batch."""
    dp = data_axes(mesh)
    bdim = 1 if grad_accum > 1 else 0

    def spec(_, leaf):
        shape = _shape(leaf)
        if len(shape) <= bdim:
            return _none(len(shape))
        a = dp if dp and shape[bdim] % _axis_size(mesh, dp) == 0 else None
        out = [None] * len(shape)
        out[bdim] = a
        return _norm(tuple(out))

    return map_with_path(spec, batch)


def cache_pspecs(cfg, cache, mesh, policy: ShardingPolicy = DEFAULT,
                 paged: bool = False):
    """KV / SSM cache sharding: batch on DP axes; heads (or sequence) on
    model. Cache leaves carry a leading layer-stack dim.

    paged: the attention leaves are page pools (``(L, n_pages, page_size,
    Hkv, hd)``). They shard the kv-head dim on ``model`` exactly like the
    rectangular cache, with no sequence fallback (the page dims stay whole
    for block-table addressing), so non-divisible head counts replicate.
    State leaves (SSM / conv / image KV) stay batch-indexed and keep their
    specs."""
    dp = data_axes(mesh)
    tp = "model" if "model" in mesh.axis_names else None

    def spec(path: str, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return ()
        name = path.rsplit("/", 1)[-1]

        def b_axis(i=1):
            return dp if dp and shape[i] % _axis_size(mesh, dp) == 0 else None

        if paged and name in ("k", "v", "c_kv", "k_rope") \
                and "cross_kv" not in path:
            if name in ("k", "v"):        # (L[, G], NP, PS, Hkv, hd)
                return _none(len(shape) - 4) + (
                    None, None, _fit(shape[-2], tp, mesh), None)
            return _none(len(shape))      # MLA pools: latent dims small

        if name in ("k", "v"):            # (L[, G], B, S, Hkv, hd)
            lead = len(shape) - 4
            h_ax = _fit(shape[-2], tp, mesh)
            s_ax = None
            if h_ax is None and policy.seq_shard_cache:
                s_ax = _fit(shape[-3], tp, mesh)
            return _none(lead) + (b_axis(lead), s_ax, h_ax, None)
        if name == "c_kv":                # (L, B, S, dc)
            return (None, b_axis(), _fit(shape[-2], tp, mesh), None)
        if name == "k_rope":              # (L, B, S, 1, dr)
            return (None, b_axis(), _fit(shape[-3], tp, mesh), None, None)
        if name == "ssm":                 # (L, B, H, P, N)
            return (None, b_axis(), _fit(shape[-3], tp, mesh), None, None)
        if name == "conv_x":              # (L, B, K-1, d_inner)
            return (None, b_axis(), None, _fit(shape[-1], tp, mesh))
        if name in ("conv_B", "conv_C"):  # small replicated streams
            return (None, b_axis(), None, None)
        return _none(len(shape))

    return map_with_path(lambda p, l: _norm(spec(p, l)), cache)


def replicate_specs(tree):
    return map_with_path(lambda _, l: _none(len(_shape(l))), tree)


# ---------------------------------------------------------------------------
# one rank's block (the counterpart of to_shardings / shard_map)
# ---------------------------------------------------------------------------


def _parts(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(number of blocks, this rank's block index) along one dimension
    whose spec entry is `entry`; a tuple of axes is row-major, outermost
    first, as JAX lays devices out."""
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    n, idx = 1, 0
    for a in axes:
        n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
    return n, idx


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of `shape` under `spec`."""
    return tuple(d // _axis_size(mesh, e) for d, e in zip(shape, spec))


def local_shard(tensor, spec: Spec, mesh, coords: Dict[str, int]):
    """This rank's block of the full `tensor` under `spec`: a contiguous
    copy of its own (the kernels read contiguous operands, and a view
    would keep the whole tensor alive), or `tensor` itself where the spec
    splits nothing; `coords` maps each axis name to the rank's index along
    it."""
    out = tensor
    for dim, entry in enumerate(spec):
        n, idx = _parts(entry, mesh, coords)
        if n > 1:
            size = out.shape[dim] // n
            out = out.narrow(dim, idx * size, size)
    return tensor if out is tensor else out.clone().contiguous()
