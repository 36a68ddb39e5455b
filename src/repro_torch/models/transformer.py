"""Model assembly of every family: forward / prefill / decode, the port
of those paths of ``repro.models.transformer`` (GQA or MLA attention, by
``cfg.is_mla``; Mamba2 blocks for ``ssm`` and ``hybrid``; gated
cross-attention blocks for ``vlm``; the dense block over frames of
``n_codebooks`` ids for ``audio``).

Each block stack keeps the JAX package's stacked layout (every leaf of
``params["layers"]`` has a leading layer axis); a Python loop takes the
place of ``lax.scan`` and reads one layer's views per step. The MoE
family's blocks hold a ``moe`` dict instead of ``ffn``, and its first
``first_k_dense`` blocks, when any, are a stack of their own,
``params["dense_layers"]``, run before ``layers`` (with a cache of their
own). The SSM family's blocks are ``{"ln", "mixer"}``; its cache is a
per-slot recurrent state (the f32 SSM state and the conv rings), which
does not grow with the sequence. The hybrid (zamba2) is the SSM stack
plus ``params["shared_attn"]``, ONE attention + FFN block with no leading
axis, applied after every ``attn_every``-th Mamba2 layer with the
sliding-window mask; its cache adds ``cache["shared_attn"]``, one ring of
K/V rows per application (a rectangle of ``min(max_len, window)`` rows at
prefill, a pool of ring pages at decode). The VLM (llama-3.2-vision) runs
``groups = n_layers // cross_attn_every`` groups, each of ``per =
cross_attn_every - 1`` self-attention blocks followed by one gated
cross-attention block: ``params["self_layers"]`` has two leading axes
``(groups, per)`` and ``params["cross_layers"]`` one, ``(groups,)``; its
cache is ``{"self_layers": {k, v}}`` with the same two leading axes (the
paged pool at decode) beside ``{"cross_kv": {k, v}}``, each cross layer's
image K/V per slot, projected once from ``image_embeds`` when they are
given and read from the cache otherwise. A stack may also be given
pre-split as a list of per-layer dicts (:func:`split_layers`, the VLM's
self layers in run order), which saves the slicing on every call.

The audio family (musicgen) is the dense family over frames: its tokens
are (B, S, K), one id per codebook, embedded as the sum of K tables
(:func:`embed_tokens`), and its logits (B, S, K, V) (:func:`logits_fn`);
everything between runs as for ``dense``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import util
from repro_torch.core.util import tree_index
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import comm
from repro_torch.models.config import ModelConfig, check_family

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# the block stacks, in the order a forward runs them (the VLM's
# self_layers and cross_layers interleave by group: :func:`_vlm_groups`)
STACKS = ("dense_layers", "layers", "self_layers", "cross_layers")
# leading layer axes of a stack's params and cache leaves: the VLM's self
# layers are (groups, per); every other stack has one
LEAD_AXES = {"self_layers": 2}


def lead_axes(stack: str) -> int:
    return LEAD_AXES.get(stack, 1)


def _lead(tree, n: int) -> Tuple[int, ...]:
    """The `n` leading (layer) axes of a stacked block tree."""
    leaf = next(iter(tree.values()))
    return _lead(leaf, n) if isinstance(leaf, dict) else tuple(leaf.shape[:n])


def split_layers(params) -> Dict:
    """Same params with each block stack as a list of per-layer views (a
    stack of two leading axes flattened in run order: group-major)."""
    out = dict(params)
    for name in STACKS:
        stack = params.get(name)
        if isinstance(stack, dict):
            lead = _lead(stack, lead_axes(name))
            views = [stack]
            for n in lead:
                views = [tree_index(v, i) for v in views for i in range(n)]
            out[name] = views
    return out


def _stacks(params) -> List:
    """(stack name, per-layer views) of every block stack, in order."""
    split = split_layers(params)
    return [(name, split[name]) for name in STACKS if name in split]


def _vlm_groups(params, cfg):
    """The VLM's groups in run order: (group, [its self layers' views],
    its cross layer's view)."""
    split = split_layers(params)
    per = cfg.cross_attn_every - 1
    selfs = split["self_layers"]
    return [(g, selfs[g * per:(g + 1) * per], cp)
            for g, cp in enumerate(split["cross_layers"])]


def _apply_attn_block(p, cfg, x, positions, cache=None, cache_pos=None,
                      block_table=None):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn = L.mla_attention if cfg.is_mla else L.attention
    a, _ = attn(p["attn"], cfg, h, positions, cache, cache_pos, block_table)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + L.moe(p["moe"], cfg, h)
    return x + L.ffn(p["ffn"], h)


def _apply_cross_block(p, cfg, x, img_kv):
    """The VLM's gated cross block: cross-attention over the image K/V,
    then the FFN scaled by ``tanh(ffn_gate)`` in x's dtype."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.cross_attention(p["xattn"], cfg, h, img_kv)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + torch.tanh(p["ffn_gate"]).to(x.dtype) * L.ffn(p["ffn"], h)


def _apply_mamba_block(p, cfg, x, state=None):
    """Residual Mamba2 block; returns (x, the mixer's new state)."""
    y, new_state = L.mamba2(p["mixer"], cfg,
                            L.rms_norm(x, p["ln"], cfg.norm_eps), state)
    return x + y, new_state


def _tp_mesh(what: str):
    """The tensor-parallel mesh of the kernel policy in force, for a leaf
    that holds one rank's vocabulary shard."""
    mesh = kops.current_kernel_policy().mesh
    if mesh is None:
        raise ValueError(f"the {what} holds a vocabulary shard, and the "
                         f"kernel policy in force carries no mesh")
    return mesh


def embed_tokens(params, cfg, tokens):
    """Token ids (B, S) to (B, S, d); the audio family's frames (B, S, K)
    to the sum of each codebook's embedding, in codebook order.

    An embedding of fewer than ``vocab_size`` rows is one rank's
    vocabulary shard (``place_on_mesh``; the audio family's (K, V, d)
    tables split on V, each codebook's alike): the vocab-parallel lookup
    gives the rows of ids in the rank's range and zeros elsewhere, and
    one all-reduce sums them (each id's row comes from one rank, so the
    sum is that row exactly). The audio family's rows are all-reduced per
    codebook, as one (..., K, d) tensor, and then summed in codebook order
    as the whole tables are, so the frame's embedding is the unsharded
    one bit for bit."""
    emb = params["embed"]
    audio = cfg.family == "audio"
    n = emb.shape[-2]
    if n == cfg.vocab_size:
        if not audio:
            return emb[tokens]
        rows = [emb[k][tokens[..., k]] for k in range(cfg.n_codebooks)]
    else:
        mesh = _tp_mesh("embedding")
        local = tokens - mesh.tp_rank * n
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        rows = emb[local] if not audio else torch.stack(
            [emb[k][local[..., k]] for k in range(cfg.n_codebooks)], -2)
        rows = comm.all_reduce_sum(torch.where(
            mine[..., None], rows,
            torch.zeros((), dtype=emb.dtype, device=emb.device)), mesh)
        if not audio:
            return rows
        rows = rows.unbind(-2)
    x = rows[0]
    for r in rows[1:]:
        x = x + r
    return x


def shared_app(cfg: ModelConfig, idx: int) -> Optional[int]:
    """The hybrid's application of its shared attention block that follows
    Mamba2 layer `idx` (the reference's ``(idx + 1) // attn_every - 1``),
    or None when none follows it (or the family has no shared block)."""
    if cfg.family != "hybrid" or (idx + 1) % cfg.attn_every:
        return None
    return (idx + 1) // cfg.attn_every - 1


def n_shared_apps(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared block per forward (0 without)."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0


def ring_rows(cfg: ModelConfig, max_len: int) -> int:
    """Rows of the hybrid's rectangular shared-attention ring: the window,
    at most max_len (the reference's ``win``)."""
    return min(max_len, cfg.sliding_window or max_len)


def _maybe_remat(f, cfg: ModelConfig, training: bool):
    """`f` under activation checkpointing when the config asks for it in a
    training forward (the reference's ``jax.checkpoint`` of each unit its
    backbone scans): the unit's activations are recomputed in the
    backward instead of kept. Calibration and KD run ``training=False``,
    so no forward hook of theirs fires twice."""
    if cfg.remat and training:
        return functools.partial(checkpoint, f, use_reentrant=False)
    return f


def backbone(params, cfg: ModelConfig, tokens, image_embeds=None,
             training: bool = False):
    """Full-sequence forward to final hidden states (B, S, d) of tokens
    (B, S), or (B, S, K) frames for the audio family. The VLM needs
    `image_embeds` (B, n_img, d), projected to each cross layer's K/V.
    With ``training`` and ``cfg.remat`` each unit the reference scans is
    rematerialized (:func:`_maybe_remat`): a dense / MoE / SSM layer, the
    hybrid's Mamba2 layer with the shared block application that follows
    it, the VLM's group and each of its self layers."""
    check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError("the VLM's forward needs image_embeds")
        self_block = _maybe_remat(
            lambda lp, h: _apply_attn_block(lp, cfg, h, positions), cfg,
            training)

        def group(h, g, selfs, cp):
            # taps: a self layer under its flat index g · per + i, a cross
            # layer (its image K/V projection included) under its group
            for i, lp in enumerate(selfs):
                L.set_scope("self_layers", g * len(selfs) + i)
                h = self_block(lp, h)
            L.set_scope("cross_layers", g)
            return _apply_cross_block(
                cp, cfg, h, L.image_kv(cp["xattn"], cfg, image_embeds))
        group = _maybe_remat(group, cfg, training)
        for g, selfs, cp in _vlm_groups(params, cfg):
            x = group(x, g, selfs, cp)
        L.set_scope("", None)
        return L.rms_norm(x, params["ln_f"], cfg.norm_eps)

    def unit(h, name, idx, lp):
        L.set_scope(name, idx)
        if not cfg.is_ssm_layer_stack:
            return _apply_attn_block(lp, cfg, h, positions)
        h, _ = _apply_mamba_block(lp, cfg, h)
        app = shared_app(cfg, idx)
        if app is not None:
            # the shared block's taps go under its application, as the
            # reference files them; the next layer sets its own scope
            L.set_scope("shared_attn", app)
            h = _apply_attn_block(params["shared_attn"], cfg, h, positions)
            L.set_scope("", None)
        return h
    unit = _maybe_remat(unit, cfg, training)
    for name, layers in _stacks(params):
        for idx, lp in enumerate(layers):
            x = unit(x, name, idx, lp)
    L.set_scope("", None)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def _head_w(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]


def logits_fn(params, cfg, hidden):
    """The lm head stays a plain matmul (tied to the embedding or not);
    the audio family's logits come back as (..., n_codebooks, vocab).
    A head of one rank's vocabulary shard gives that slice of the logits,
    and one all-gather assembles them, the same on every rank."""
    out = hidden @ _head_w(params, cfg).to(hidden.dtype)
    books = cfg.n_codebooks if cfg.family == "audio" else 1
    if out.shape[-1] != books * cfg.vocab_size:
        out = comm.all_gather_last(out, _tp_mesh("lm head"))
    if cfg.family == "audio":
        out = out.unflatten(-1, (cfg.n_codebooks, cfg.vocab_size))
    return out


def forward(params, cfg, tokens, image_embeds=None):
    return logits_fn(params, cfg, backbone(params, cfg, tokens,
                                           image_embeds))


# ---------------------------------------------------------------------------
# loss: sequence-chunked cross-entropy (the full (B, S, V) logits tensor is
# never made at once)
# ---------------------------------------------------------------------------


def _xent(logits, labels):
    """logits (..., V); labels (...) with -1 = masked. (sum, count)."""
    lf = logits.float()
    ll = lf.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((torch.logsumexp(lf, dim=-1) - ll) * mask).sum(), mask.sum()


def loss_fn(params, cfg: ModelConfig, batch, training: bool = True):
    """Mean token NLL of batch {'tokens', 'labels'[, 'image_embeds']},
    the port of ``repro.models.transformer.loss_fn``; the batch moves to
    the params' device. `training` selects rematerialization
    (:func:`backbone`). The loss runs over sequence chunks of
    ``cfg.loss_chunk`` tokens when that divides the length, each chunk's
    logits recomputed in the backward (the reference's
    ``jax.checkpoint(chunk_loss)``)."""
    dev = params["embed"].device
    img = batch.get("image_embeds")
    h = backbone(params, cfg, batch["tokens"].to(dev),
                 None if img is None else img.to(dev), training=training)
    labels = batch["labels"].to(dev)
    w = _head_w(params, cfg)
    S = h.shape[1]
    chunk = min(cfg.loss_chunk or S, S)
    if S % chunk:
        chunk = S

    def chunk_loss(h_c, y_c):
        logits = h_c @ w.to(h_c.dtype)
        if cfg.family == "audio":
            logits = logits.unflatten(-1, (cfg.n_codebooks, cfg.vocab_size))
        return _xent(logits, y_c)

    if chunk < S and torch.is_grad_enabled():
        chunk_loss = functools.partial(checkpoint, chunk_loss,
                                       use_reentrant=False)
    tot = cnt = 0.0
    for c in range(0, S, chunk):
        t, n = chunk_loss(h[:, c:c + chunk], labels[:, c:c + chunk])
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# init: the FP teacher (the JAX package's init laws, drawn by torch)
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """FP params of a model of any family under the JAX package's init
    laws (``repro.models.transformer.init_params`` and
    ``layers.init_*``): embedding N(0, 0.02) (audio: one (V, d) table per
    codebook), an untied lm head (audio: (d, K·V)) and every linear N(0,
    1/d_in), biases 0, norms 1; the MoE's f32 router, stacked experts (E,
    d, f) / (E, f, d) and shared experts at ``n_shared_experts · f``, its
    ``first_k_dense`` blocks at ``dense_d_ff``; MLA's six projections; the
    Mamba2 mixer's convs N(0, 0.2), ``A_log`` = log linspace(1, 16),
    ``D`` = 1, ``dt_bias`` uniform on [log 1e-3, log 1e-1] (those three
    f32); the hybrid's Mamba2 stack and its one shared attention + FFN
    block (``shared_attn``, no leading axis). Each stack's leaves carry a
    leading layer axis; the VLM's ``self_layers`` two, (groups,
    cross_attn_every - 1), and its gated ``cross_layers`` (``xattn``: wq,
    wk, wv, wo, per-head q / k norms; ``ffn``) one, their ``gate`` and
    ``ffn_gate`` 0 as JAX sets them (so each cross block starts as the
    identity). `generator` lives on `device`; the numbers differ from
    JAX's draws (another generator)."""
    dt, d = torch_dtype(cfg), cfg.d_model
    f32 = torch.float32

    def normal(shape, std, dtype=dt):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dtype)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    def lin(n, d_in, d_out, bias=False):
        p = {"w": normal((n, d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = full((n, d_out), 0.0)
        return p

    def ffn(n, d_ff):
        return {"w_gate": lin(n, d, d_ff), "w_up": lin(n, d, d_ff),
                "w_down": lin(n, d_ff, d)}

    def attn(n):
        if cfg.is_mla:
            H, dc = cfg.n_heads, cfg.kv_lora_rank
            return {"wq": lin(n, d, H * cfg.qk_head_dim),
                    "w_dkv": lin(n, d, dc),
                    "w_kr": lin(n, d, cfg.qk_rope_dim),
                    "w_uk": lin(n, dc, H * cfg.qk_nope_dim),
                    "w_uv": lin(n, dc, H * cfg.v_head_dim),
                    "wo": lin(n, H * cfg.v_head_dim, d),
                    "kv_norm": full((n, dc), 1.0)}
        hd = cfg.head_dim
        a = {"wq": lin(n, d, cfg.n_heads * hd, cfg.qkv_bias),
             "wk": lin(n, d, cfg.n_kv_heads * hd, cfg.qkv_bias),
             "wv": lin(n, d, cfg.n_kv_heads * hd, cfg.qkv_bias),
             "wo": lin(n, cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            a["q_norm"] = full((n, hd), 1.0)
            a["k_norm"] = full((n, hd), 1.0)
        return a

    def moe(n):
        E, f = cfg.n_experts, cfg.moe_d_ff
        p = {"router": {"w": normal((n, d, E), 1.0 / math.sqrt(d), f32)},
             "w_gate": {"w": normal((n, E, d, f), 1.0 / math.sqrt(d))},
             "w_up": {"w": normal((n, E, d, f), 1.0 / math.sqrt(d))},
             "w_down": {"w": normal((n, E, f, d), 1.0 / math.sqrt(f))}}
        if cfg.n_shared_experts:
            p["shared"] = ffn(n, cfg.n_shared_experts * f)
        return p

    def attn_block(n, mlp_key, mlp):
        return {"ln1": full((n, d), 1.0), "attn": attn(n),
                "ln2": full((n, d), 1.0), mlp_key: mlp(n)}

    def cross_block(n):
        hd = cfg.head_dim
        xattn = {"wq": lin(n, d, cfg.n_heads * hd),
                 "wk": lin(n, d, cfg.n_kv_heads * hd),
                 "wv": lin(n, d, cfg.n_kv_heads * hd),
                 "wo": lin(n, cfg.n_heads * hd, d), "gate": full((n,), 0.0),
                 "q_norm": full((n, hd), 1.0), "k_norm": full((n, hd), 1.0)}
        return {"ln1": full((n, d), 1.0), "xattn": xattn,
                "ln2": full((n, d), 1.0), "ffn": ffn(n, cfg.d_ff),
                "ffn_gate": full((n,), 0.0)}

    def mamba_block(n):
        di, H, K = cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv
        gn = cfg.ssm_groups * cfg.ssm_state
        dt_lo, dt_hi = math.log(1e-3), math.log(1e-1)
        mixer = {"wz": lin(n, d, di), "wx": lin(n, d, di),
                 "wB": lin(n, d, gn), "wC": lin(n, d, gn),
                 "wdt": lin(n, d, H), "out_proj": lin(n, di, d),
                 "A_log": torch.log(torch.linspace(
                     1.0, 16.0, H, device=device)).expand(n, H).clone(),
                 "D": full((n, H), 1.0, f32),
                 "dt_bias": (torch.rand((n, H), generator=generator,
                                        device=device)
                             * (dt_hi - dt_lo) + dt_lo),
                 "norm_w": full((n, di), 1.0)}
        for s, width in (("x", di), ("B", gn), ("C", gn)):
            mixer["conv_" + s] = normal((n, K, width), 0.2)
            mixer["conv_b" + s] = full((n, width), 0.0)
        return {"ln": full((n, d), 1.0), "mixer": mixer}

    n = cfg.n_layers
    audio = cfg.family == "audio"
    vocab = cfg.n_codebooks * cfg.vocab_size if audio else cfg.vocab_size
    p = {"embed": normal((cfg.n_codebooks, cfg.vocab_size, d) if audio
                         else (cfg.vocab_size, d), 0.02),
         "ln_f": full((d,), 1.0)}
    if cfg.family in ("ssm", "hybrid"):
        p["layers"] = mamba_block(n)
        if cfg.family == "hybrid":
            p["shared_attn"] = tree_index(
                attn_block(1, "ffn", lambda m: ffn(m, cfg.d_ff)), 0)
    elif cfg.family == "vlm":
        groups, per = stack_lead(cfg)["self_layers"]
        p["self_layers"] = util.tree_map(
            lambda t: t.unflatten(0, (groups, per)),
            attn_block(groups * per, "ffn", lambda m: ffn(m, cfg.d_ff)))
        p["cross_layers"] = cross_block(groups)
    elif cfg.family == "moe":
        k = cfg.first_k_dense
        if k:
            p["dense_layers"] = attn_block(
                k, "ffn", lambda m: ffn(m, cfg.dense_d_ff or cfg.d_ff))
        p["layers"] = attn_block(n - k, "moe", moe)
    else:
        p["layers"] = attn_block(n, "ffn", lambda m: ffn(m, cfg.d_ff))
    if audio or not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal((d, vocab), 1.0 / math.sqrt(d))}
    return p


def stack_lead(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Leading layer axes of each attention-cache stack: {"layers": (n,)}
    for the dense, SSM and hybrid families; the MoE family's
    ``first_k_dense`` leading blocks as "dense_layers"; the VLM's
    "self_layers" as (groups, cross_attn_every - 1)."""
    check_family(cfg)
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        return {"self_layers": (cfg.n_layers // per, per - 1)}
    if cfg.family == "moe" and cfg.first_k_dense:
        return {"dense_layers": (cfg.first_k_dense,),
                "layers": (cfg.n_layers - cfg.first_k_dense,)}
    return {"layers": (cfg.n_layers,)}


def stack_depths(cfg: ModelConfig) -> Dict[str, int]:
    """Layers of each attention-cache stack (:func:`stack_lead`'s axes
    multiplied out)."""
    return {name: math.prod(lead) for name, lead in stack_lead(cfg).items()}


def image_cache(cfg: ModelConfig, batch: int, device="cuda"):
    """The VLM's per-slot image K/V, one per cross layer: {"k" / "v":
    (groups, B, n_img, Hkv, D)} in the model dtype, zero until an image is
    projected into it."""
    shape = (cfg.n_layers // cfg.cross_attn_every, batch,
             cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {leaf: torch.zeros(shape, dtype=torch_dtype(cfg), device=device)
            for leaf in ("k", "v")}


def cache_leaves(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Each attention-cache leaf's shape per row: GQA's k and v (Hkv, D);
    MLA's compressed latent c_kv (kv_lora_rank,) and shared RoPE key
    k_rope (1, qk_rope_dim)."""
    if cfg.is_mla:
        return {"c_kv": (cfg.kv_lora_rank,), "k_rope": (1, cfg.qk_rope_dim)}
    return {leaf: (cfg.n_kv_heads, cfg.head_dim) for leaf in ("k", "v")}


def state_cache(cfg: ModelConfig, batch: int, device="cuda"):
    """The Mamba2 stack's per-slot recurrent state, whatever max_len is:
    {"ssm": (L, B, H, P, N) f32, "conv_x" / "conv_B" / "conv_C": (L, B,
    K-1, C) rings in the model dtype}."""
    dt = torch_dtype(cfg)
    n, gn = cfg.n_layers, cfg.ssm_groups * cfg.ssm_state

    def ring(width):
        return torch.zeros((n, batch, cfg.ssm_conv - 1, width), dtype=dt,
                           device=device)
    ssm = torch.zeros((n, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state), dtype=torch.float32, device=device)
    return {"ssm": ssm, "conv_x": ring(cfg.d_inner), "conv_B": ring(gn),
            "conv_C": ring(gn)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Rectangular cache, one per block stack: {stack: {leaf: (L, B,
    max_len, *row)}} over :func:`cache_leaves`, in the model dtype. The
    SSM family's is its recurrent state (:func:`state_cache`) under
    "layers"; the hybrid adds "shared_attn": {"k" / "v": (n_apps, B, win,
    Hkv, D)}, one ring of ``win = min(max_len, window)`` rows per
    application of the shared block (:func:`ring_rows`). The VLM's
    "self_layers" leaves are (groups, per, B, max_len, Hkv, D), beside
    its per-slot image K/V "cross_kv" (:func:`image_cache`)."""
    check_family(cfg)
    dt = torch_dtype(cfg)
    if cfg.is_ssm_layer_stack:
        cache = {"layers": state_cache(cfg, batch, device)}
        if cfg.family == "hybrid":
            win = ring_rows(cfg, max_len)
            cache["shared_attn"] = {
                leaf: torch.zeros((n_shared_apps(cfg), batch, win) + row,
                                  dtype=dt, device=device)
                for leaf, row in cache_leaves(cfg).items()}
        return cache
    cache = {name: {leaf: torch.zeros(lead + (batch, max_len) + row,
                                      dtype=dt, device=device)
                    for leaf, row in cache_leaves(cfg).items()}
             for name, lead in stack_lead(cfg).items()}
    if cfg.family == "vlm":
        cache["cross_kv"] = image_cache(cfg, batch, device)
    return cache


def _commit_state(state, new, active=None):
    """Write a layer's new recurrent state into its cache views, in place;
    with `active` (B,) bool, rows of inactive slots keep their state bit
    for bit (the reference's ``cache_select_active``)."""
    for k, v in new.items():
        if active is not None:
            keep = active.reshape((-1,) + (1,) * (v.dim() - 1))
            v = torch.where(keep, v, state[k])
        state[k].copy_(v)


def _shared_positions(cfg, pos, S: int, attn_cache, block_tables):
    """(positions, cache_pos, ring table) of the hybrid's shared block.
    With ``block_tables["ring"]`` (B, pages): the paged decode (S == 1,
    per-slot (B,) `pos`), whose write row wraps modulo the slot's virtual
    ring ``pages · page_size`` on the device, the query position staying
    absolute. Without: the rectangular ring of ``win`` rows, written at
    the reference's rows: ``min(pos, win - S)`` for a prefill, ``pos %
    win`` for a decode (`pos` scalar or per-slot (B,)); the decode mask
    wraps at the buffer's length. A prompt longer than the ring raises
    (the reference's prefill fails there too)."""
    bt = block_tables.get("ring") if block_tables else None
    if bt is not None:
        if S != 1:
            raise NotImplementedError(
                "the hybrid's paged forward is the one-token decode: a ring "
                "table wraps its write row per token")
        rows = bt.shape[1] * attn_cache["k"].shape[2]
        pos = pos.long()
        return pos[:, None], torch.remainder(pos, rows), bt
    win = attn_cache["k"].shape[2]
    if S > win:
        raise ValueError(f"a prompt of {S} tokens is longer than the shared "
                         f"attention's ring of {win} rows")
    steps = torch.arange(S, device=attn_cache["k"].device)
    if isinstance(pos, torch.Tensor) and pos.dim():
        pos = pos.long()
        wpos = torch.clamp(pos, max=win - S) if S > 1 \
            else torch.remainder(pos, win)
        return pos[:, None] + steps[None, :], wpos, None
    pos = int(pos)
    return pos + steps, min(pos, win - S) if S > 1 else pos % win, None


def _ssm_forward(params, cfg, x, cache, pos=0, block_tables=None,
                 active=None):
    """The cached forward of the SSM and hybrid families: S == 1 takes
    each mixer's recurrent step (a one-token prefill too), S > 1 the
    full-sequence SSD with the terminal state rebuilt; the state is
    written in place, kept for inactive slots with `active`. The hybrid's
    shared block, after every ``attn_every``-th layer, writes and reads
    its application's ring (:func:`_shared_positions`)."""
    S = x.shape[1]
    leaves = cache["layers"]
    attn = cache.get("shared_attn")
    if attn is not None:
        positions, cache_pos, bt = _shared_positions(cfg, pos, S, attn,
                                                     block_tables)
    for i, lp in enumerate(split_layers(params)["layers"]):
        state = {k: v[i] for k, v in leaves.items()}
        x, ns = _apply_mamba_block(lp, cfg, x, state if S == 1 else None)
        _commit_state(state, ns, active)
        app = shared_app(cfg, i)
        if app is not None:
            x = _apply_attn_block(params["shared_attn"], cfg, x, positions,
                                  {k: v[app] for k, v in attn.items()},
                                  cache_pos, bt)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), cache


def _vlm_forward(params, cfg, x, cache, positions, pos, bt,
                 image_embeds=None):
    """The VLM's cached forward: each group's self layers over their cache
    (rectangular or paged through `bt`), then its cross block over the
    image K/V, projected from `image_embeds` when given (and written into
    ``cache["cross_kv"]``, cast to its dtype) or read from that cache,
    per slot."""
    sc, ckv = cache["self_layers"], cache["cross_kv"]
    for g, selfs, cp in _vlm_groups(params, cfg):
        for j, lp in enumerate(selfs):
            x = _apply_attn_block(lp, cfg, x, positions,
                                  {k: v[g, j] for k, v in sc.items()}, pos,
                                  bt)
        if image_embeds is not None:
            kv = L.image_kv(cp["xattn"], cfg, image_embeds)
            for leaf, t in zip(("k", "v"), kv):
                ckv[leaf][g] = t.to(ckv[leaf].dtype)
        else:
            kv = (ckv["k"][g], ckv["v"][g])
        x = _apply_cross_block(cp, cfg, x, kv)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), cache


def _cached_forward(params, cfg, tokens, cache, pos, block_tables=None,
                    image_embeds=None):
    """Prefill or decode over a rectangular cache (`pos` a scalar or
    per-slot (B,)), or a paged decode, verify or suffix prefill (per-slot
    (B,) pos and ``block_tables={"linear": (B, pages)}``). Writes the
    cache in place; returns (hidden, cache)."""
    check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    if cfg.is_ssm_layer_stack:
        return _ssm_forward(params, cfg, x, cache, pos, block_tables)
    S = x.shape[1]
    steps = torch.arange(S, device=x.device)
    if isinstance(pos, torch.Tensor) and pos.dim():
        positions = pos.long()[:, None] + steps[None, :]          # (B, S)
    else:
        positions = int(pos) + steps                              # (S,)
    bt = block_tables.get("linear") if block_tables else None
    if cfg.family == "vlm":
        return _vlm_forward(params, cfg, x, cache, positions, pos, bt,
                            image_embeds)
    for name, layers in _stacks(params):
        leaves = cache[name]
        for i, lp in enumerate(layers):
            x = _apply_attn_block(lp, cfg, x, positions,
                                  {k: v[i] for k, v in leaves.items()}, pos,
                                  bt)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), cache


def prefill(params, cfg, tokens, cache, last_idx: Optional[int] = None,
            start_pos=None, block_tables=None, image_embeds=None):
    """Process the prompt; returns (logits at `last_idx`, cache).

    Without `start_pos`: a full prefill into a rectangular cache at
    position 0. `last_idx`: the final real prompt token when `tokens` is
    right-padded to a bucket (causality makes its logits and the cache
    rows up to it identical to an unpadded prefill); default the last.

    With `start_pos` (B,) and ``block_tables={"linear": (B, pages)}``: the
    **suffix prefill** of a prefix-cache hit. `cache` is the paged pool,
    rows ``[0, start_pos)`` of each slot already hold the shared prefix's
    KV, and `tokens` is only the uncached suffix: token j writes row
    ``start_pos + j`` through the slot's table and attends to every
    earlier row, the paged S > 1 route of the speculative verify. Rows
    wrap modulo the table's rectangle, so `tokens` must end inside it: a
    pad row past it would overwrite the shared prefix.

    `image_embeds` (B, n_img, d), the VLM's: each cross layer's image K/V
    is projected once into ``cache["cross_kv"]``; without them the cross
    layers read that cache as it is (zero in a fresh one, as the JAX
    package's engine leaves it)."""
    if start_pos is None:
        h, cache = _cached_forward(params, cfg, tokens, cache, 0,
                                   image_embeds=image_embeds)
    else:
        if not block_tables:
            raise ValueError("a suffix prefill runs over the pool: pass "
                             "block_tables")
        h, cache = _cached_forward(params, cfg, tokens, cache, start_pos,
                                   block_tables=block_tables)
    h = h[:, -1:] if last_idx is None else h[:, last_idx:last_idx + 1]
    return logits_fn(params, cfg, h), cache


def decode_step(params, cfg, token, cache, pos, block_tables=None,
                active=None):
    """One decode step: token (B, S) (S == 1 normally), pos (B,) per-slot
    positions (or a scalar shared by the batch, on a rectangle). Over a
    paged pool with block_tables {"linear": (B, pages)}; without tables
    over the rectangular cache of :func:`init_cache`, the reference's
    ``paged=False`` layout (each slot's rows at ``pos``, the whole
    rectangle read under the decode mask). The SSM family's step runs
    over its per-slot state cache (no tables, `pos` unused); `active`
    (B,) bool keeps the state of inactive slots. The hybrid takes both:
    the state cache with `active`, and its shared block's ring, a pool
    through ``block_tables={"ring": (B, ring_pages)}`` or the rectangle's
    ring of ``win`` rows, at the absolute positions `pos`. The VLM's cross
    layers read ``cache["cross_kv"]`` per slot. The audio family's `token`
    is (B, S, K) and its logits (B, S, K, V). Returns (logits (B, S, V),
    cache)."""
    if cfg.is_ssm_layer_stack:
        h, cache = _ssm_forward(params, cfg, embed_tokens(params, cfg, token),
                                cache, pos, block_tables, active)
    else:
        if not block_tables:
            name = next(iter(stack_lead(cfg)))
            rows = next(iter(cache[name].values())).shape[lead_axes(name)]
            if rows != token.shape[0]:
                raise ValueError(
                    f"a decode without block_tables runs over a rectangular "
                    f"cache of the batch's {token.shape[0]} slots; this one "
                    f"has {rows} (a paged pool? pass block_tables)")
        h, cache = _cached_forward(params, cfg, token, cache, pos,
                                   block_tables=block_tables)
    return logits_fn(params, cfg, h), cache
