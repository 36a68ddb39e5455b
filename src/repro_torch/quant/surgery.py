"""Packed parameter-tree surgery, the port's copy of the serving half of
``repro.quant.surgery``:

- :func:`abstract_quantized_params` — the shape/dtype template of a
  NanoQuant-packed dense or MoE model with GQA or MLA attention, of a
  Mamba2 (SSM) model, of a zamba2 hybrid, of a llama-3.2-vision VLM or
  of a musicgen audio model (for the artifact loader and for building a
  packed model of a published shape from a seed);
- :func:`merge_projection_groups` — the merged QKV / gate-up operands
  the grouped kernel launches read (padded rank + ``rmask``, padded s1
  columns set to 0);
- :func:`rank_truncated_view` — the zero-copy rank-r' draft view that
  self-speculative decoding reads (``serve.speculative``);
- :func:`packed_model_bytes` — the checkpoint's storage accounting;
- :func:`quantizable_paths` — every linear the quantizer selects;
- :func:`place_on_mesh` / :func:`place_cache_on_mesh` — one rank's shards
  of a parameter tree or a cache under ``sharding.rules`` (the reference
  places a global array per device; here each rank holds its own).

The selection rule is ``core.layout.quantizable_linear``, the copy of
the JAX package's: every linear ``{"w": (d_in, d_out)}`` (or stacked
experts ``(E, d_in, d_out)``) inside a block stack whose min dim is >=
``min_dim``, whose d_in packs into 32-bit words and whose name is not
excluded (the MoE router stays FP32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.bpw import nanoquant_bits, rank_for_bpw
from repro_torch.core.layout import BLOCK_STACKS, PACK_ALIGN, \
    quantizable_linear
from repro_torch.models.config import ModelConfig, check_family


class LeafSpec(NamedTuple):
    """Shape and dtype name of one parameter leaf (no storage)."""
    shape: Tuple[int, ...]
    dtype: str


def param_specs(cfg: ModelConfig) -> Dict:
    """FP parameter template of a model of any family — the tree
    ``repro.models.transformer.init_params`` builds, each block stack
    with a leading axis of its length. The MoE family's
    ``layers`` hold a ``moe`` block (router, stacked experts, optional
    shared experts) instead of ``ffn``; its first ``first_k_dense``
    blocks, when any, form the ``dense_layers`` stack with an FFN of
    ``dense_d_ff``. The router is float32 whatever ``cfg.dtype`` is. An
    MLA config's attention is ``repro.models.layers.init_mla``'s: the
    query, latent down, shared RoPE key, latent-to-key and latent-to-value
    up projections, the output and the latent's norm. An SSM block is
    ``{"ln", "mixer"}``, the mixer ``repro.models.layers.init_mamba2``'s:
    the split input projections wz / wx / wB / wC / wdt and out_proj, the
    depthwise conv kernels (K, C) of the x / B / C streams with their
    biases (arrays, not linears, so never packed), A_log, D and dt_bias
    (float32 whatever ``cfg.dtype`` is) and the gated norm's weight. The
    hybrid's ``layers`` are the SSM stack and ``shared_attn`` is ONE
    attention + FFN block with no leading axis (zamba2's block shared by
    every application). The VLM's ``self_layers`` are attention + FFN
    blocks with two leading axes ``(groups, cross_attn_every - 1)``, and
    its ``cross_layers`` one gated cross-attention block per group
    (``repro.models.transformer._init_block(kind="cross")``): ``ln1``,
    ``xattn`` (wq, wk, wv, wo, the per-head q_norm / k_norm and the scalar
    ``gate``), ``ln2``, ``ffn`` and the scalar ``ffn_gate``. The audio
    family's blocks are the dense family's; its ``embed`` is one table per
    codebook, (n_codebooks, vocab, d), and its ``lm_head.w`` (d,
    n_codebooks · vocab)."""
    check_family(cfg)
    dt, d, hd = cfg.dtype, cfg.d_model, cfg.head_dim

    def lin(lead, d_in, d_out, bias=False):
        p = {"w": LeafSpec(lead + (d_in, d_out), dt)}
        if bias:
            p["b"] = LeafSpec(lead + (d_out,), dt)
        return p

    def ffn(lead, d_ff):
        return {"w_gate": lin(lead, d, d_ff), "w_up": lin(lead, d, d_ff),
                "w_down": lin(lead, d_ff, d)}

    def mla(lead):
        H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        dv, dc = cfg.v_head_dim, cfg.kv_lora_rank
        return {"wq": lin(lead, d, H * (dn + dr)), "w_dkv": lin(lead, d, dc),
                "w_kr": lin(lead, d, dr), "w_uk": lin(lead, dc, H * dn),
                "w_uv": lin(lead, dc, H * dv), "wo": lin(lead, H * dv, d),
                "kv_norm": LeafSpec(lead + (dc,), dt)}

    def gqa(lead):
        attn = {"wq": lin(lead, d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": lin(lead, d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": lin(lead, d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": lin(lead, cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            attn["q_norm"] = LeafSpec(lead + (hd,), dt)
            attn["k_norm"] = LeafSpec(lead + (hd,), dt)
        return attn

    def block(lead, d_ff=None):
        attn = mla(lead) if cfg.is_mla else gqa(lead)
        p = {"ln1": LeafSpec(lead + (d,), dt), "attn": attn,
             "ln2": LeafSpec(lead + (d,), dt)}
        if d_ff is not None:
            p["ffn"] = ffn(lead, d_ff)
            return p
        E, f = cfg.n_experts, cfg.moe_d_ff
        moe = {"router": {"w": LeafSpec(lead + (d, E), "float32")},
               "w_gate": lin(lead + (E,), d, f),
               "w_up": lin(lead + (E,), d, f),
               "w_down": lin(lead + (E,), f, d)}
        if cfg.n_shared_experts:
            moe["shared"] = ffn(lead, cfg.n_shared_experts * f)
        p["moe"] = moe
        return p

    def mamba(lead):
        di, H, K = cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv
        gn = cfg.ssm_groups * cfg.ssm_state
        mixer = {"wz": lin(lead, d, di), "wx": lin(lead, d, di),
                 "wB": lin(lead, d, gn), "wC": lin(lead, d, gn),
                 "wdt": lin(lead, d, H), "out_proj": lin(lead, di, d),
                 "A_log": LeafSpec(lead + (H,), "float32"),
                 "D": LeafSpec(lead + (H,), "float32"),
                 "dt_bias": LeafSpec(lead + (H,), "float32"),
                 "norm_w": LeafSpec(lead + (di,), dt)}
        for s, c in (("x", di), ("B", gn), ("C", gn)):
            mixer[f"conv_{s}"] = LeafSpec(lead + (K, c), dt)
            mixer[f"conv_b{s}"] = LeafSpec(lead + (c,), dt)
        return {"ln": LeafSpec(lead + (d,), dt), "mixer": mixer}

    def cross(lead):
        xattn = {"wq": lin(lead, d, cfg.n_heads * hd),
                 "wk": lin(lead, d, cfg.n_kv_heads * hd),
                 "wv": lin(lead, d, cfg.n_kv_heads * hd),
                 "wo": lin(lead, cfg.n_heads * hd, d),
                 "gate": LeafSpec(lead, dt),
                 "q_norm": LeafSpec(lead + (hd,), dt),
                 "k_norm": LeafSpec(lead + (hd,), dt)}
        return {"ln1": LeafSpec(lead + (d,), dt), "xattn": xattn,
                "ln2": LeafSpec(lead + (d,), dt), "ffn": ffn(lead, cfg.d_ff),
                "ffn_gate": LeafSpec(lead, dt)}

    # audio: one embedding table per codebook, and a head over all of them
    books = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    tree = {"ln_f": LeafSpec((d,), dt),
            "embed": LeafSpec(books + (cfg.vocab_size, d), dt)}
    n = cfg.n_layers
    if cfg.family == "vlm":
        groups = n // cfg.cross_attn_every
        tree["self_layers"] = block((groups, cfg.cross_attn_every - 1),
                                    cfg.d_ff)
        tree["cross_layers"] = cross((groups,))
    elif cfg.is_ssm_layer_stack:
        tree["layers"] = mamba((n,))
        if cfg.family == "hybrid":
            tree["shared_attn"] = block((), cfg.d_ff)
    elif cfg.family in ("dense", "audio"):
        tree["layers"] = block((n,), cfg.d_ff)
    else:
        tree["layers"] = block((n - cfg.first_k_dense,))
        if cfg.first_k_dense:
            tree["dense_layers"] = block((cfg.first_k_dense,),
                                         cfg.dense_d_ff or cfg.d_ff)
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": LeafSpec(
            (d, math.prod(books) * cfg.vocab_size), dt)}
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
    JAX package's quantizer emits, built without a single weight: every
    block stack's selected linears packed, everything else FP."""
    def q(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and isinstance(v.get("w"), LeafSpec) \
                    and quantizable_linear(k, v["w"].shape, min_dim):
                struct, _ = _packed_struct(v["w"].shape, target_bpw,
                                           rank_align, k_align)
                if "b" in v:
                    struct["b"] = v["b"]
                out[k] = struct
            else:
                out[k] = q(v) if isinstance(v, dict) else v
        return out

    new = dict(param_specs(cfg))
    for stack in BLOCK_STACKS:
        if stack in new:
            new[stack] = q(new[stack])
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


# blocks whose sibling projections read different inputs: the VLM's
# cross-attention projects the hidden state through wq and the image
# through wk / wv (``layers.cross_attention`` / ``layers.image_kv``)
SPLIT_INPUT_BLOCKS = frozenset({"xattn"})


def merge_projection_groups(params):
    """Add merged operand groups (``wqkv`` / ``wgu``) wherever a block
    holds packed sibling projections that read the same activations with
    a common packed d_in, so the model layer issues ONE grouped kernel
    launch instead of three/two. The per-projection leaves are kept;
    the input tree is not modified (a new dict is returned where
    anything was added).

    Under tensor parallelism it runs on one rank's shards
    (:func:`place_on_mesh` first), so each group stacks the rank's own
    wq / wk / wv (gate / up) d_out shards, which stay head-aligned. This
    departs from the reference, which shards the merged group's padded
    Nmax axis: explicit TP needs each rank's q / k / v columns to be whole
    heads, which a cut of the padded axis is not. The numbers are the
    same.

    A departure from the JAX package: its merge also builds ``wqkv`` in
    the VLM's cross-attention blocks (:data:`SPLIT_INPUT_BLOCKS`), whose
    wq reads the hidden state while wk / wv read the image, so no layer
    ever reads that group (≈ 25 MB per cross layer at full size); the port
    skips it, which changes no output."""
    def walk(d, name=None):
        out = {}
        changed = False
        for k, v in d.items():
            if isinstance(v, dict):
                nv = walk(v, k)
                changed = changed or (nv is not v)
                out[k] = nv
            else:
                out[k] = v
        for names, merged_key in MERGE_GROUPS:
            if merged_key in out or name in SPLIT_INPUT_BLOCKS:
                continue
            if "router" in out:
                # MoE expert stacks run through dense_expert (kernel #1's
                # expert grid), not ffn(): a merged copy would never be read
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


# ---------------------------------------------------------------------------
# placement on a tensor-parallel mesh
# ---------------------------------------------------------------------------


def kv_layout(cfg: ModelConfig, mesh) -> Tuple[bool, Optional[slice]]:
    """How this rank holds and reads the kv heads on a tensor-parallel
    `mesh`: (replicated, read). The one decision that placement
    (:func:`param_placement`, :func:`local_cache`), the engine's checks
    and ``models.layers.attention`` share.

    replicated: ``n_kv_heads`` does not divide the ``model`` axis, so wk /
    wv (and their biases) and the caches stay whole on every rank. This
    departs from the reference, whose rule splits wk's d_out inside a
    head and lets GSPMD regather it, which explicit TP cannot; the pool's
    placement is still the reference's ``cache_pspecs(paged=True)``,
    which replicates it there. read: the slice of the held kv heads this
    rank's query heads read, their GQA group's one head (None: every kv
    head it holds, the heads sharded with the query heads or no mesh).
    Raises where the rank's query heads would straddle GQA groups over
    replicated kv heads (the same on every rank)."""
    n = 1 if mesh is None else mesh.tp
    if n == 1 or cfg.is_mla or cfg.n_kv_heads % n == 0:
        return False, None
    hq, G = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    if cfg.n_heads % n or G % hq:
        raise NotImplementedError(
            f"{cfg.n_kv_heads} kv heads do not divide over {n} ranks and "
            f"{cfg.n_heads} query heads do not split into runs inside GQA "
            f"groups of {G}")
    first = mesh.tp_rank * hq // G
    return True, slice(first, first + 1)


def param_placement(params, cfg: ModelConfig, mesh, policy=None):
    """The spec tree :func:`place_on_mesh` places `params` by:
    ``sharding.rules.param_pspecs`` under `policy` (default
    :data:`sharding.rules.SERVE`), with wk / wv (and their biases)
    replicated where ``n_kv_heads`` does not divide the model axis
    (:func:`kv_layout`)."""
    from repro_torch.sharding import rules
    specs = rules.param_pspecs(cfg, params, mesh,
                               policy if policy is not None else rules.SERVE)
    if not kv_layout(cfg, mesh)[0]:
        return specs

    def fix(path, spec):
        parts = path.split("/")
        if len(parts) > 1 and parts[-2] in ("wk", "wv"):
            return (None,) * len(spec)
        return spec
    return rules.map_with_path(fix, specs)


def place_on_mesh(params, cfg: ModelConfig, mesh, policy=None):
    """This rank's shards of a (quantized or FP) parameter tree on a
    serving mesh per ``sharding.rules``: packed U/s1 d_out-sharded for
    column-parallel projections, packed V/s2 d_in-sharded for row-parallel
    ones, FP ``w`` / ``b`` paired the same way, an MoE's routed expert
    stacks split on E with every expert's factors whole (the router
    whole, the shared experts' FFN paired as a dense FFN), MLA's
    ``w_uk`` / ``w_uv`` on the head axis and its role-less ``w_dkv`` /
    ``w_kr`` whole, a Mamba2 mixer's wz / wx on d_out and out_proj on
    d_in by whole SSD heads with conv_x, its bias and norm_w on the same
    d_inner columns (wB / wC / wdt, the other convs and the per-head
    A_log / D / dt_bias whole), the hybrid's unstacked shared block and
    the VLM's self and cross layers paired as a dense block, the
    embedding (the audio family's K tables alike) and lm head split on
    the vocabulary, everything non-divisible whole. The default policy is :data:`repro_torch.sharding.rules.SERVE` (tensor-parallel
    only, V replicated), the layout the launches of ``kernels.ops`` read.
    Returns a new tree of contiguous tensors (a whole leaf is the input's
    own tensor).

    One departure from the reference: where ``n_kv_heads`` does not divide
    the model axis (qwen1.5-110b's smoke config, one kv head), wk and wv
    stay whole on every rank, as the pool does, and each rank's query
    heads read the kv head their GQA group maps to (:func:`kv_layout`)."""
    from repro_torch.sharding import rules
    specs = param_placement(params, cfg, mesh, policy)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, sp) for v, sp in zip(tree, spec)]
        if not isinstance(tree, torch.Tensor):
            return tree
        return rules.local_shard(tree, spec, mesh, mesh.coords)

    return walk(params, specs)


def local_cache(make, cfg: ModelConfig, mesh, device):
    """A cache tree allocated as this rank's blocks: ``make(device)``
    builds the whole tree; on a tensor-parallel `mesh` it is built on the
    meta device and every leaf is allocated (zeros) at its block's shape
    under ``sharding.rules.cache_pspecs(paged=True)`` with no sequence
    fallback. That is the pool's placement, and the rectangular prefill
    cache takes it too: its kv heads split with the query heads or stay
    whole (:func:`kv_layout`); the reference's rule for it would fall
    back to the sequence dim, which explicit TP has no regather for. So
    does the VLM's per-slot image K/V, whose rule is the rectangle's: a
    rank holds the kv heads its wk / wv give, never a block of the image
    rows. The Mamba2 state holds the rank's SSD heads (``ssm``) and
    d_inner columns (``conv_x``) beside the whole ``conv_B`` /
    ``conv_C``."""
    if mesh is None or mesh.tp == 1:
        return make(device)
    from repro_torch.sharding import rules
    full = make("meta")
    specs = rules.cache_pspecs(
        cfg, full, mesh, dataclasses.replace(rules.SERVE,
                                             seq_shard_cache=False),
        paged=True)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return torch.zeros(rules.local_shape(tree.shape, spec, mesh),
                           dtype=tree.dtype, device=device)

    return walk(full, specs)


def place_cache_on_mesh(cache, cfg: ModelConfig, mesh, policy=None,
                        paged: bool = False):
    """This rank's shards of a KV / SSM cache per
    ``sharding.rules.cache_pspecs`` (kv heads, or the sequence dim, on
    ``model``; the slot dim on the data axes when divisible). ``paged``
    for a page pool (``serve.paging``): it shards its kv-head dim only,
    whole where that does not divide."""
    from repro_torch.sharding import rules
    specs = rules.cache_pspecs(cfg, cache, mesh,
                               policy if policy is not None else rules.SERVE,
                               paged=paged)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return rules.local_shard(tree, spec, mesh, mesh.coords)

    return walk(cache, specs)


def quantizable_paths(params, cfg: ModelConfig, min_dim: int = 48
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, linear dict)] for every quantizable linear of the model's
    block stacks, keys in sorted order (the reference's walk)."""
    out = []

    def walk(d, path):
        for k in sorted(d.keys()):
            v = d[k]
            if not isinstance(v, dict):
                continue
            if "w" in v and not isinstance(v["w"], dict):
                if quantizable_linear(k, v["w"].shape, min_dim):
                    out.append((path + (k,), v))
            else:
                walk(v, path + (k,))

    for stack in BLOCK_STACKS:
        if stack in params and isinstance(params[stack], dict):
            walk(params[stack], (stack,))
    return out


# ---------------------------------------------------------------------------
# storage accounting
# ---------------------------------------------------------------------------


def packed_model_bytes(cfg: ModelConfig, target_bpw: float = 1.0,
                       min_dim: int = 48, rank_align: int = 32,
                       k_align: int = 32) -> Dict[str, float]:
    """Storage accounting of the quantized checkpoint (App. F style), the
    port of ``repro.quant.surgery.packed_model_bytes``: packed linears
    (scales counted fp16, as the paper stores them) plus the FP16 residue
    (embeddings, norms, head, sub-min_dim linears). Padded qv rows and s2
    columns of a ``k_align`` past 32 are real bytes and are counted."""
    k_align = max(32, k_align)
    q_bits = qw_bits = fp_bits = 0

    def walk(node, in_stack):
        nonlocal q_bits, qw_bits, fp_bits
        for k in sorted(node):
            v = node[k]
            if isinstance(v, LeafSpec):
                fp_bits += math.prod(v.shape) * 16
            elif in_stack and isinstance(v.get("w"), LeafSpec) \
                    and quantizable_linear(k, v["w"].shape, min_dim):
                *lead, d_in, d_out = v["w"].shape
                r = rank_for_bpw(d_out, d_in, target_bpw, rank_align)
                pad_k = -(-d_in // k_align) * k_align - d_in
                q_bits += math.prod(lead) * (nanoquant_bits(d_out, d_in, r)
                                             + pad_k * r + 16 * pad_k)
                qw_bits += math.prod(v["w"].shape) * 16
                if "b" in v:
                    fp_bits += math.prod(v["b"].shape) * 16
            else:
                walk(v, in_stack)

    specs = param_specs(cfg)
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, LeafSpec):
            fp_bits += math.prod(v.shape) * 16
        else:
            walk({k: v} if k not in BLOCK_STACKS else v, k in BLOCK_STACKS)
    return {
        "fp16_total_gb": (fp_bits + qw_bits) / 8 / 1e9,
        "quantized_gb": (q_bits + fp_bits) / 8 / 1e9,
        "linears_bpw": q_bits / max(qw_bits / 16, 1),
        "compression_x": (fp_bits + qw_bits) / max(q_bits + fp_bits, 1),
    }
