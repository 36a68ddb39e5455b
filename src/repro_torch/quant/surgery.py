"""Packed parameter-tree surgery, the port's copy of the serving half of
``repro.quant.surgery``:

- :func:`abstract_quantized_params` — the shape/dtype template of a
  NanoQuant-packed dense model (for the artifact loader and for building
  a packed model of a published shape from a seed);
- :func:`merge_projection_groups` — the merged QKV / gate-up operands
  the grouped kernel launches read (padded rank + ``rmask``, padded s1
  columns set to 0);
- :func:`rank_truncated_view` — the zero-copy rank-r' draft view that
  self-speculative decoding reads (``serve.speculative``).

The selection rule mirrors ``repro.core.layout.quantizable_linear``:
every linear ``{"w": (d_in, d_out)}`` inside a transformer block whose
min dim is >= ``min_dim`` and whose d_in packs into 32-bit words.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.bpw import rank_for_bpw
from repro_torch.models.config import ModelConfig

PACK_ALIGN = 32


class LeafSpec(NamedTuple):
    """Shape and dtype name of one parameter leaf (no storage)."""
    shape: Tuple[int, ...]
    dtype: str


def quantizable_linear(w_shape, min_dim: int) -> bool:
    return (len(w_shape) >= 2
            and min(w_shape[-2:]) >= min_dim
            and w_shape[-2] % PACK_ALIGN == 0)


def param_specs(cfg: ModelConfig) -> Dict:
    """FP parameter template of a dense-family model — the tree
    ``repro.models.transformer.init_params`` builds, with the layer
    stack's leading axis of length ``n_layers``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family, not {cfg.family!r}")
    dt, d, hd, L = cfg.dtype, cfg.d_model, cfg.head_dim, cfg.n_layers

    def lin(d_in, d_out, bias=False):
        p = {"w": LeafSpec((L, d_in, d_out), dt)}
        if bias:
            p["b"] = LeafSpec((L, d_out), dt)
        return p

    attn = {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
            "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wo": lin(cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = LeafSpec((L, hd), dt)
        attn["k_norm"] = LeafSpec((L, hd), dt)
    tree = {
        "ln_f": LeafSpec((d,), dt),
        "embed": LeafSpec((cfg.vocab_size, d), dt),
        "layers": {
            "ln1": LeafSpec((L, d), dt),
            "attn": attn,
            "ln2": LeafSpec((L, d), dt),
            "ffn": {"w_gate": lin(d, cfg.d_ff), "w_up": lin(d, cfg.d_ff),
                    "w_down": lin(cfg.d_ff, d)},
        },
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": LeafSpec((d, cfg.vocab_size), dt)}
    return tree


def _packed_struct(w_shape, target_bpw: float, rank_align: int,
                   k_align: int = 32):
    """Template of one packed linear; the d_in dim is padded to
    ``k_align`` exactly as ``repro.core.packing.pack_quantized`` stores
    it. Returns (struct, rank)."""
    *lead, d_in, d_out = w_shape
    r = rank_for_bpw(d_out, d_in, target_bpw, rank_align)
    k_align = max(32, k_align)
    kp = -(-d_in // k_align) * k_align
    lead = tuple(lead)
    return {
        "qu_t": LeafSpec(lead + (r // 32, d_out), "uint32"),
        "qv": LeafSpec(lead + (kp // 32, r), "uint32"),
        "s1": LeafSpec(lead + (d_out,), "float32"),
        "s2": LeafSpec(lead + (kp,), "float32"),
    }, r


def abstract_quantized_params(cfg: ModelConfig, target_bpw: float = 1.0,
                              min_dim: int = 48, rank_align: int = 32,
                              k_align: int = 32) -> Dict:
    """LeafSpec tree of the NanoQuant-packed model — the structure the
    JAX package's quantizer emits, built without a single weight."""
    def q(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and isinstance(v.get("w"), LeafSpec) \
                    and quantizable_linear(v["w"].shape, min_dim):
                struct, _ = _packed_struct(v["w"].shape, target_bpw,
                                           rank_align, k_align)
                if "b" in v:
                    struct["b"] = v["b"]
                out[k] = struct
            else:
                out[k] = q(v) if isinstance(v, dict) else v
        return out

    new = dict(param_specs(cfg))
    new["layers"] = q(new["layers"])
    return new


# ---------------------------------------------------------------------------
# merged projection groups
# ---------------------------------------------------------------------------

# (sibling keys sharing the block input, merged key)
MERGE_GROUPS = (
    (("wq", "wk", "wv"), "wqkv"),
    (("w_gate", "w_up"), "wgu"),
)


def _pad_last(a: torch.Tensor, targets: Dict[int, int]) -> torch.Tensor:
    """Zero-pad trailing dims: targets maps axis-from-end -> size."""
    spec = []
    for ax_fe in range(1, a.dim() + 1):
        spec += [0, targets.get(ax_fe, a.shape[-ax_fe]) - a.shape[-ax_fe]]
    return F.pad(a, spec) if any(spec) else a


def _stack_group(subs):
    """Stack P packed sibling linears into one grouped operand set: every
    projection padded to the widest rank R and output Nmax (padded s1
    columns are 0; ``rmask`` zeros the padded rank columns)."""
    ranks = [int(s["qv"].shape[-1]) for s in subs]
    nouts = [int(s["qu_t"].shape[-1]) for s in subs]
    R, n_max = max(ranks), max(nouts)
    lead = tuple(subs[0]["qv"].shape[:-2])
    ax = len(lead)                           # new group axis position
    dev = subs[0]["qv"].device
    mp = {
        "qv": torch.stack([_pad_last(s["qv"], {1: R}) for s in subs], ax),
        "qu_t": torch.stack([_pad_last(s["qu_t"], {2: R // 32, 1: n_max})
                             for s in subs], ax),
        "s1": torch.stack([_pad_last(s["s1"].float(), {1: n_max})
                           for s in subs], ax),
        "s2": torch.stack([s["s2"].float() for s in subs], ax),
    }
    rmask = torch.stack([(torch.arange(R, device=dev) < r).float()
                         for r in ranks])
    mp["rmask"] = rmask.expand(lead + rmask.shape).contiguous()
    if any("b" in s for s in subs):
        bs = []
        for s, n in zip(subs, nouts):
            b = s["b"].float() if "b" in s else \
                torch.zeros(lead + (n,), device=dev)
            bs.append(_pad_last(b, {1: n_max}))
        mp["b"] = torch.stack(bs, ax)
    return mp


def merge_projection_groups(params):
    """Add merged operand groups (``wqkv`` / ``wgu``) wherever a block
    holds packed sibling projections that read the same activations with
    a common packed d_in, so the model layer issues ONE grouped kernel
    launch instead of three/two. The per-projection leaves are kept;
    the input tree is not modified (a new dict is returned where
    anything was added)."""
    def walk(d):
        out = {}
        changed = False
        for k, v in d.items():
            if isinstance(v, dict):
                nv = walk(v)
                changed = changed or (nv is not v)
                out[k] = nv
            else:
                out[k] = v
        for names, merged_key in MERGE_GROUPS:
            if merged_key in out:
                continue
            subs = [out.get(nm) for nm in names]
            if not all(isinstance(s, dict) and "qu_t" in s for s in subs):
                continue
            if len({tuple(s["qv"].shape[:-1]) for s in subs}) != 1:
                continue                     # packed d_in / lead mismatch
            out[merged_key] = _stack_group(subs)
            changed = True
        return out if changed else d

    return walk(params) if isinstance(params, dict) else params


# ---------------------------------------------------------------------------
# rank-truncated views (the self-speculative draft)
# ---------------------------------------------------------------------------


def truncated_rank(r: int, rank_frac: float, align: int = PACK_ALIGN) -> int:
    """r' = frac·r rounded down to `align`, clamped to [align, r] (the
    packed rank axis is consumed in 32-row bit-words, so r' must stay a
    multiple of 32)."""
    return min(int(r), max(align, int(int(r) * rank_frac) // align * align))


def rank_truncated_view(params, rank_frac: float, align: int = PACK_ALIGN):
    """Zero-copy draft view of a packed parameter tree: every packed
    linear dict whose rank r gives r' = :func:`truncated_rank` < r is
    copied shallowly and gains ``eff_rank = r'`` (a plain int); every
    tensor in the view IS the tree's tensor. The layers pass ``eff_rank``
    to the kernels, which read only the leading r' rank columns of qv and
    the leading r'//32 packed rows of qu_t in place, so the truncated
    forward is the full model with the trailing r − r' components zeroed.

    Merged groups (``wqkv`` / ``wgu``) truncate their padded common rank,
    so each member effectively keeps min(r_p, r'). Dicts and lists (the
    engine's per-layer list) with nothing truncated below them are
    returned as the same objects."""
    if not (0.0 < rank_frac <= 1.0):
        raise ValueError(f"rank_frac must be in (0, 1], got {rank_frac}")

    def walk(node):
        if isinstance(node, list):
            out = [walk(v) for v in node]
            return node if all(a is b for a, b in zip(out, node)) else out
        if not isinstance(node, dict):
            return node
        if "qu_t" in node and "qv" in node:
            r = int(node["qv"].shape[-1])
            rp = truncated_rank(r, rank_frac, align)
            return node if rp == r else {**node, "eff_rank": rp}
        out = {k: walk(v) for k, v in node.items()}
        return node if all(out[k] is v for k, v in node.items()) else out

    return walk(params)
