"""Dense-, MoE-, SSM-, hybrid- and VLM-family layers (GQA or MLA
attention, the Mamba2 mixer, the VLM's gated cross-attention), the port
of ``repro.models.layers``.

Params are plain dicts of tensors, as in the JAX package. Linear layers go
through :func:`dense`, which runs a full-precision matmul or a NanoQuant
packed low-rank binary matmul when the dict carries packed leaves. KV
caches are updated in place (the JAX package returns fresh arrays): the
engine owns one cache, a paged pool or a rectangle, and every decode step
writes into it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.quant.surgery import kv_layout
from repro_torch.sharding.rules import tp_role

# --------------------------------------------------------------------------
# calibration taps (paper Alg. 1 Phase 1): while a StatCollector is
# installed (:func:`taps`), every named dense() records its input's second
# moments before the matmul ("in") and hooks its output tensor for the
# output gradient's ("out") — the diagonal K-FAC statistics behind D̃_in /
# D̃_out. With no collector installed a named dense() costs one contextvar
# read.
# --------------------------------------------------------------------------


class _Tap:
    def __init__(self, collector):
        self.collector = collector
        self.scope = ("", None)      # (stack, layer index), set per block

    def record_in(self, name: str, x, expert: bool = False) -> None:
        stack, idx = self.scope
        self.collector.accumulate(stack, name, "in", idx, x, expert)

    def hook_out(self, name: str, y, expert: bool = False) -> None:
        if y.requires_grad:
            stack, idx = self.scope
            c = self.collector
            y.register_hook(
                lambda g: c.accumulate(stack, name, "out", idx, g, expert))


_TAP: contextvars.ContextVar = contextvars.ContextVar(
    "nanoquant_torch_tap", default=None)


@contextlib.contextmanager
def taps(collector):
    """Install `collector` (``core.precond.StatCollector``) for a scope."""
    token = _TAP.set(_Tap(collector))
    try:
        yield
    finally:
        _TAP.reset(token)


def set_scope(stack: str, idx) -> None:
    """Name the block the next taps belong to (no-op without taps)."""
    tap = _TAP.get()
    if tap is not None:
        tap.scope = (stack, idx)


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def sign_ste(u):
    """sign with a straight-through gradient (paper Eq. 10); 0 -> +1."""
    s = torch.sign(u)
    s = torch.where(s == 0, torch.ones_like(s), s).to(u.dtype)
    return u + (s - u).detach()


def _ste_matmul(p, x):
    """Latent STE linear (block reconstruction Step 3, paper Eq. 10):
    W_eff = diag(s1)·sign(𝒰)·sign(𝒱)ᵀ·diag(s2) with straight-through
    gradients to the continuous latents. lv: (d_in, r), lu: (d_out, r);
    stacked experts carry a leading expert axis on every leaf and on x,
    their scales (E, 1, d)."""
    xs = x * p["s2"].to(x.dtype)
    t = xs @ sign_ste(p["lv"]).to(x.dtype)
    y = t @ sign_ste(p["lu"]).to(x.dtype).mT
    return y * p["s1"].to(x.dtype)


def dense(p: dict, x, name: Optional[str] = None, reduce: bool = True):
    """FP, STE-latent or packed-binary linear. x: (..., d_in) -> (...,
    d_out). A packed dict of a draft view (``quant.surgery.
    rank_truncated_view``) carries ``eff_rank``: the kernel then reads only
    the leading rank columns. `name` keys the calibration taps and gives
    the linear's tensor-parallel role (``sharding.rules.tp_role``), as the
    reference's ``dense`` passes it: under a mesh a row-parallel linear's
    partial sums are all-reduced before its bias, which is added once.
    ``reduce=False`` leaves a row-parallel linear's partial sums to the
    caller, who folds them into an all-reduce of its own (the MoE layer's
    shared experts); its bias is then added on the model axis's rank 0
    only, so that the sum holds it once."""
    tap = _TAP.get() if name is not None else None
    if tap is not None:
        tap.record_in(name, x)
    mesh = kops.current_kernel_policy().mesh
    tp = None if mesh is None else tp_role(name)
    finish = tp == "row" and reduce
    if "qu_t" in p:      # packed low-rank binary path (paper Eq. 1)
        y = kops.lowrank_binary_matmul(x, p["qv"], p["qu_t"], p["s1"],
                                       p["s2"], tp=tp if reduce else None,
                                       eff_rank=p.get("eff_rank"))
    elif "lu" in p:      # continuous latents with STE (refinement phase)
        y = _ste_matmul(p, x)
    else:
        y = x @ p["w"].to(x.dtype)
        if finish:
            y = kops.finish_row_parallel(y)
    if tap is not None:
        tap.hook_out(name, y)
    if "b" in p and (finish or tp != "row" or mesh.tp_rank == 0):
        y = y + p["b"].to(y.dtype)
    return y


def dense_merged(mp: dict, x, dims: Sequence[int]):
    """Grouped packed projections sharing the input `x` (QKV / gate-up):
    ONE fused kernel launch instead of len(dims). `mp` is the merged group
    of ``quant.surgery.merge_projection_groups``; `dims` the true output
    widths. Per-projection biases behave as in :func:`dense`."""
    ys = kops.lowrank_binary_matmul_merged(x, mp, dims,
                                           eff_rank=mp.get("eff_rank"))
    if "b" in mp:
        ys = [y + mp["b"][i, :n].to(y.dtype)
              for i, (y, n) in enumerate(zip(ys, dims))]
    return ys


def dense_expert(p: dict, x, name: Optional[str] = None):
    """Batched-expert linear: x (E, C, d_in) with stacked weights (E, ...)
    -> (E, C, d_out). Packed experts are one launch of kernel #1 with the
    expert axis as its group axis (``ops.lowrank_binary_matmul_expert``);
    latents run the STE linear of every expert at once (the JAX package's
    ``vmap(_ste_matmul)``). `name` keys the calibration taps, which reduce
    over the capacity rows only: one moment per expert and channel."""
    tap = _TAP.get() if name is not None else None
    if tap is not None:
        tap.record_in(name, x, expert=True)
    if "qu_t" in p:
        y = kops.lowrank_binary_matmul_expert(
            x, p["qv"], p["qu_t"], p["s1"], p["s2"],
            eff_rank=p.get("eff_rank"))
    elif "lu" in p:
        y = _ste_matmul({"lu": p["lu"], "lv": p["lv"],
                         "s1": p["s1"][:, None], "s2": p["s2"][:, None]}, x)
    else:
        y = torch.einsum("ecd,edf->ecf", x, p["w"].to(x.dtype))
    if tap is not None:
        tap.hook_out(name, y, expert=True)
    return y


def _use_merged(p: dict, key: str, x) -> bool:
    return key in p and \
        kops.current_kernel_policy().use_merged_projections(x.device)


def _kv_read(cfg):
    """The slice of the held kv heads this rank's query heads read under
    the mesh in force (``quant.surgery.kv_layout``), or None: every held
    head."""
    mesh = kops.current_kernel_policy().mesh
    return None if mesh is None else kv_layout(cfg, mesh)[1]


def _width(lin: dict) -> int:
    """A linear's output width, read from its (packed or FP) leaves: under
    tensor parallelism the rank's d_out shard."""
    if "qu_t" in lin:
        return lin["qu_t"].shape[-1]
    return lin["lu"].shape[-2] if "lu" in lin else lin["w"].shape[-1]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (S,) or (B, S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv             # (..., S, D/2)
    if ang.dim() == 2:                                   # (S, D/2)
        ang = ang[None, :, None, :]
    else:                                                # (B, S, D/2)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _mask(q_pos, k_pos, window: int, causal: bool = True):
    """q_pos (Sq,) or (B, Sq); k_pos (Sk,). Bool (Sq, Sk) or (B, Sq, Sk)."""
    q = q_pos[..., :, None]
    m = torch.ones((q_pos.shape[-1], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k_pos <= q)
    if window:
        m = m & (k_pos > q - window)
    return m


def sdpa(q, k, v, mask, scale: float):
    """Plain attention: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), mask (Sq,
    Sk) or per-slot (B, Sq, Sk); masked scores are -1e30."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    msk = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    s = torch.where(msk, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Sq, Hq, -1)


def _flash_kv_step(m_run, l_run, acc, qblk, kblk, vblk, qpos, kpos,
                   scale: float, window: int):
    """One key chunk of :func:`sdpa_flash`'s online softmax: the running
    max, normalizer and f32 accumulator of a query chunk, updated."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk).float() * scale
    msk = _mask(qpos, kpos, window)
    s = torch.where(msk[None, None, None], s, torch.full_like(s, -1e30))
    m_new = torch.maximum(m_run, s.amax(-1))
    alpha = torch.exp(m_run - m_new)
    pexp = torch.exp(s - m_new[..., None])
    l_new = l_run * alpha + pexp.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", pexp.to(vblk.dtype), vblk).float()
    return m_new, l_new, acc


def sdpa_flash(q, k, v, q_pos, k_pos, scale: float, window: int = 0,
               q_chunk: int = 512, kv_chunk: int = 1024):
    """Memory-bounded attention, the port of the reference's
    ``sdpa_flash``: an outer loop over query chunks and an inner loop over
    key chunks with an online softmax (the flash-attention algorithm in
    plain PyTorch ops). q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), q_pos (Sq,)
    and k_pos (Sk,) the positions of the causal (+ `window`) mask; each
    length a multiple of its chunk (cut to the length when longer). When
    a gradient is taken each key chunk's step is checkpointed, as the
    reference's ``jax.checkpoint`` of it: the backward recomputes its
    (q_chunk, kv_chunk) scores instead of keeping every chunk pair's."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"sdpa_flash: lengths ({Sq}, {Sk}) are not "
                         f"multiples of the chunks ({q_chunk}, {kv_chunk})")
    step = _flash_kv_step
    if torch.is_grad_enabled():
        def step(*a):
            return checkpoint(_flash_kv_step, *a, use_reentrant=False)
    outs = []
    for qs in range(0, Sq, q_chunk):
        qblk = q[:, qs:qs + q_chunk].reshape(B, q_chunk, Hkv, G, D)
        qpos = q_pos[qs:qs + q_chunk]
        m = torch.full((B, Hkv, G, q_chunk), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dv), dtype=torch.float32,
                          device=q.device)
        for ks in range(0, Sk, kv_chunk):
            m, l, acc = step(m, l, acc, qblk, k[:, ks:ks + kv_chunk],
                             v[:, ks:ks + kv_chunk],
                             qpos, k_pos[ks:ks + kv_chunk], scale, window)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(v.dtype))                   # (B, Hkv, G, cq, Dv)
    # (nq, B, Hkv, G, cq, Dv) -> (B, Sq, Hq, Dv)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, Hq, Dv)


def paged_cache_write(pool, new, block_table, row):
    """Write S tokens into a paged KV pool, in place: token j of `new`
    (B, S, ...) lands in row ``row[b] + j`` of slot b's virtual rectangle
    (page ``block_table[b, r // page_size]``, offset ``r % page_size``;
    rows wrap modulo the rectangle). Inactive slots' tables are all-zero,
    so their writes land on the null page. pool: (n_pages, page_size,
    ...); block_table: (B, pages); row: (B,). Returns `pool`."""
    ps = pool.shape[1]
    S = new.shape[1]
    rows = torch.remainder(
        row.long()[:, None] + torch.arange(S, device=pool.device),
        block_table.shape[1] * ps)
    page = block_table.long().gather(1, rows // ps)              # (B, S)
    pool[page, rows % ps] = new.to(pool.dtype)
    return pool


def gather_pages(pool, block_table):
    """A slot's pages as its virtual rectangle: (n_pages, page_size, ...)
    x (B, pages) -> (B, pages·page_size, ...). Row index == cache
    position, so :func:`_decode_mask` applies; rows of unmapped (null
    page) entries lie past every valid position and mask out."""
    g = pool[block_table.long()]
    return g.reshape(block_table.shape[0], -1, *pool.shape[2:])


def _cache_write(buf, new, cache_pos):
    """Write `new` (B, S, ...) into a rectangular cache `buf` (B, Smax,
    ...) at row offset `cache_pos`, in place: a scalar shared by the
    batch, or a per-slot (B,) vector (the continuous-batching decode).
    Returns `buf`."""
    S = new.shape[1]
    new = new.to(buf.dtype)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim():
        r = cache_pos.long()[:, None] + torch.arange(S, device=buf.device)
        buf[torch.arange(buf.shape[0], device=buf.device)[:, None], r] = new
    else:
        p = int(cache_pos)
        buf[:, p:p + S] = new
    return buf


def _cache_valid(k_pos, cache_pos, S: int):
    """Rows of a cache holding real entries: (Smax,) for a scalar
    cache_pos, (B, 1, Smax) for a per-slot (B,) one."""
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim():
        return (k_pos[None, :] < cache_pos[:, None] + S)[:, None, :]
    return k_pos < cache_pos + S


def _decode_mask(q_pos, cache_pos, n_rows: int, window: int):
    """Mask of S queries over a cache of ``n_rows`` rows that may be a
    ring. Query j writes row ``cache_pos + j``; row r last held the key of
    position ``(q + j) - ((cache_pos + j - r) mod n_rows)``, negative when
    never written, so rows that later queries of the same call write
    reconstruct as negative and causality is implicit. For a linear cache
    (cache_pos == q_pos) it is the causal (+ window) mask. q_pos (S,) or
    per-slot (B, S); cache_pos scalar or (B,). Returns (S, n_rows) or
    (B, S, n_rows)."""
    dev = q_pos.device
    r = torch.arange(n_rows, device=dev)
    j = torch.arange(q_pos.shape[-1], device=dev)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim():
        cp = cache_pos.long()[:, None] + j[None, :]                 # (B, S)
        delta = torch.remainder(cp[:, :, None] - r[None, None, :], n_rows)
    else:
        delta = torch.remainder((cache_pos + j)[:, None] - r[None, :],
                                n_rows)                             # (S, rows)
    abs_pos = q_pos.long()[..., :, None] - delta
    m = abs_pos >= 0
    if window:
        m = m & (abs_pos > q_pos.long()[..., :, None] - window)
    return m


def attention(p, cfg, x, positions, cache=None, cache_pos=None,
              block_table=None):
    """GQA attention. Returns (out, cache).

    cache None: training / full-sequence forward. With a rectangular
    cache dict(k=(B, Smax, Hkv, D), v=...), the reference's two routes:
    S tokens are written at rows ``cache_pos`` (a scalar, or per-slot
    (B,) with positions (B, S); :func:`_cache_write`); S > 1 (the prompt
    prefill) attends over its fresh k / v (``sdpa_flash`` from
    ``flash_threshold``), S == 1 (a decode step) reads the whole rectangle
    under :func:`_decode_mask`, which hides the rows never written (a
    bucketed prefill's pad rows past the prompt among them) and, for the
    hybrid's ring of ``win`` rows, wraps at the buffer's length. With
    ``block_table`` (B, pages): the cache is a paged pool
    (k/v: (n_pages, page_size, Hkv, D)) and the S tokens (a decode, the
    speculative verify or a prefix hit's suffix prefill) write and read
    it at per-slot rows ``cache_pos`` (B,), positions (B, S). Nothing here
    assumes ``cache_pos == positions``: the hybrid's ring passes its write
    row wrapped modulo the ring's rows and its query positions absolute,
    and the write (:func:`paged_cache_write`), #2, #3 and their plain
    versions place row r at position ``q - ((cache_pos - r) mod rows)``.

    Head counts are read from the projections' widths, so under tensor
    parallelism the layer runs on the rank's heads (its wq / wk / wv
    shards, its pool or rectangle of kv heads:
    ``quant.surgery.kv_layout``); wo is then
    row-parallel and its all-reduce (in :func:`dense`) restores the full
    output. The megakernel declines under a mesh."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if (cache is not None and block_table is not None and S == 1
            and not cfg.qk_norm and _use_merged(p, "wqkv", x)
            and "b" not in p["wqkv"]
            and "qu_t" in p.get("wo", {}) and "b" not in p["wo"]):
        # fused decode step: QKV → paged attention → wo in ONE kernel.
        # None for non-qualifying launches: the unfused chain below runs.
        mega = kops.decode_step_megakernel(
            x[:, 0], p["wqkv"], p["wo"], cache["k"], cache["v"],
            block_table, positions[:, 0], cache_pos, head_dim=hd,
            dims=(cfg.n_heads * hd, cfg.n_kv_heads * hd),
            theta=cfg.rope_theta, scale=1.0 / math.sqrt(hd),
            window=cfg.sliding_window, eff_rank=p["wqkv"].get("eff_rank"),
            eff_rank_o=p["wo"].get("eff_rank"))
        if mega is not None:
            y, k_new, v_new = mega
            paged_cache_write(cache["k"], k_new[:, None], block_table,
                              cache_pos)
            paged_cache_write(cache["v"], v_new[:, None], block_table,
                              cache_pos)
            return y[:, None], cache
    dq, dkv = _width(p["wq"]), _width(p["wk"])
    if _use_merged(p, "wqkv", x):
        q, k, v = dense_merged(p["wqkv"], x, (dq, dkv, dkv))
    else:
        q = dense(p["wq"], x, "attn.wq")
        k = dense(p["wk"], x, "attn.wk")
        v = dense(p["wv"], x, "attn.wv")
    Hq, Hkv = dq // hd, dkv // hd
    q = q.reshape(B, S, Hq, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    kv = _kv_read(cfg)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    window = cfg.sliding_window

    if block_table is not None:
        # paged decode: page-mapped write, then the block-table walk
        paged_cache_write(cache["k"], k, block_table, cache_pos)
        paged_cache_write(cache["v"], v, block_table, cache_pos)
        kp, vp = cache["k"], cache["v"]
        if kv is not None:
            kp, vp = kp[:, :, kv], vp[:, :, kv]
        o = kops.paged_attention(q, kp, vp, block_table, positions[:, 0],
                                 cache_pos, window=window, scale=scale)
    elif cache is not None and S == 1:
        # rectangular decode: the whole rectangle under the decode mask
        ck = _cache_write(cache["k"], k, cache_pos)
        cv = _cache_write(cache["v"], v, cache_pos)
        if kv is not None:
            ck, cv = ck[:, :, kv], cv[:, :, kv]
        o = sdpa(q, ck, cv, _decode_mask(positions, cache_pos, ck.shape[1],
                                         window), scale)
    else:
        if cache is not None:
            _cache_write(cache["k"], k, cache_pos)
            _cache_write(cache["v"], v, cache_pos)
        if kv is not None:
            k, v = k[:, :, kv], v[:, :, kv]
        if S >= cfg.flash_threshold:
            # the reference's route at long lengths (the cache-less forward
            # and the rectangular prefill), with its GQA head repeat
            G = q.shape[2] // k.shape[2]
            if G > 1:
                k = k.repeat_interleave(G, dim=2)
                v = v.repeat_interleave(G, dim=2)
            o = sdpa_flash(q, k, v, positions, positions, scale, window,
                           cfg.flash_q_chunk, cfg.flash_kv_chunk)
        else:
            o = sdpa(q, k, v, _mask(positions, positions, window), scale)
    return dense(p["wo"], o.reshape(B, S, -1), "attn.wo"), cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2) — compressed latent cache, absorbed read
# --------------------------------------------------------------------------


def mla_attention(p, cfg, x, positions, cache=None, cache_pos=None,
                  block_table=None):
    """Multi-head latent attention. Returns (out, cache). The cache holds
    the compressed ``c_kv`` (kv_lora_rank wide) and the shared RoPE key
    ``k_rope`` (qk_rope_dim) per row; the query is absorbed into the
    latent space (``w_uk``) and the output leaves it through ``w_uv``, so
    K and V are never materialised. The four packed projections go
    through :func:`dense`; the read is plain torch ops, as the reference
    keeps it in plain XLA (no paged-attention kernel serves MLA).

    cache None: full-sequence forward. A rectangular cache dict(c_kv=(B,
    Smax, dc), k_rope=(B, Smax, 1, dr)): the S tokens write rows
    ``cache_pos`` (scalar or per-slot (B,), :func:`_cache_write`) and read
    the whole rectangle under the causal mask and :func:`_cache_valid`, as
    the reference reads it; a prompt prefill at position 0 (S > 1) reads
    its S fresh rows only (the rows past S that the reference masks add
    exactly 0). With
    ``block_table`` (B, pages): the cache is a paged pool (c_kv: (n_pages,
    page_size, dc), k_rope: (n_pages, page_size, 1, dr)); the S tokens (a
    decode, the speculative verify, a prefix hit's suffix prefill) write
    rows ``cache_pos + j`` and read the slot's gathered pages under
    :func:`_decode_mask`. Rounding points are the reference's: q, c_kv,
    the RoPE'd q_rope / k_rope, q_lat, each score einsum, the
    probabilities, o_lat and o in x's dtype; the score sum, scale, mask
    and softmax in f32.

    The head count is read from wq's width, so under tensor parallelism
    the layer runs on the rank's heads: its column shards of wq and of
    the FP ``w_uk`` / ``w_uv`` (split on the head axis), wo row-parallel
    with its all-reduce in :func:`dense`. The role-less ``w_dkv`` / ``w_kr``
    stay whole, as do the latent pool and rectangle, so every rank writes
    the same latent rows."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    dv, dc = cfg.v_head_dim, cfg.kv_lora_rank
    H = _width(p["wq"]) // (dn + dr)
    q = dense(p["wq"], x, "attn.wq").reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv = rms_norm(dense(p["w_dkv"], x, "attn.w_dkv"), p["kv_norm"],
                   cfg.norm_eps)
    k_rope = apply_rope(dense(p["w_kr"], x, "attn.w_kr")[:, :, None, :],
                        positions, cfg.rope_theta)              # (B, S, 1, dr)
    if block_table is not None:
        paged_cache_write(cache["c_kv"], c_kv, block_table, cache_pos)
        paged_cache_write(cache["k_rope"], k_rope, block_table, cache_pos)
        c_kv = gather_pages(cache["c_kv"], block_table)       # (B, T, dc)
        k_rope = gather_pages(cache["k_rope"], block_table)   # (B, T, 1, dr)
        msk = _decode_mask(positions, cache_pos, c_kv.shape[1], 0)
    elif cache is not None and (S == 1 or isinstance(cache_pos, torch.Tensor)
                                or cache_pos != 0):
        # a decode, or any call at an offset: the whole rectangle
        c_kv = _cache_write(cache["c_kv"], c_kv, cache_pos)
        k_rope = _cache_write(cache["k_rope"], k_rope, cache_pos)
        k_pos = torch.arange(c_kv.shape[1], device=x.device)
        msk = _mask(positions, k_pos, 0) & _cache_valid(k_pos, cache_pos, S)
    else:
        if cache is not None:
            _cache_write(cache["c_kv"], c_kv, 0)
            _cache_write(cache["k_rope"], k_rope, 0)
        msk = _mask(positions, positions, 0)
    w_uk = p["w_uk"]["w"].to(x.dtype).reshape(dc, H, dn)
    w_uv = p["w_uv"]["w"].to(x.dtype).reshape(dc, H, dv)
    q_lat = torch.einsum("bshd,chd->bshc", q_nope, w_uk)        # (B, S, H, dc)
    s = torch.einsum("bshc,btc->bhst", q_lat, c_kv).float()
    s = s + torch.einsum("bshd,btxd->bhst", q_rope,
                         k_rope.to(q_rope.dtype)).float()
    s = s * (1.0 / math.sqrt(dn + dr))
    m = msk[:, None] if msk.dim() == 3 else msk[None, None]
    s = torch.where(m, s, torch.full_like(s, -1e30))
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btc->bshc", prob, c_kv)          # (B, S, H, dc)
    o = torch.einsum("bshc,chd->bshd", o_lat, w_uv)
    return dense(p["wo"], o.reshape(B, S, H * dv), "attn.wo"), cache


# --------------------------------------------------------------------------
# cross-attention (VLM layers) — gated, non-causal, image K/V cacheable
# --------------------------------------------------------------------------


def cross_attention(p, cfg, x, image_kv):
    """Gated cross-attention of the hidden state over an image's K/V (the
    llama-3.2-vision layer): per-head RMS-normed q from wq, the plain
    :func:`sdpa` over all ``n_img`` keys (no mask, no RoPE, scale
    1/sqrt(D)), the output through wo scaled by ``tanh(gate)`` in x's
    dtype. image_kv: (k, v), each (B, n_img, Hkv, D), from
    :func:`image_kv`. The reference keeps this plain, so it is plain torch
    ops here: no kernel serves it.

    The head count is read from wq's width, so under tensor parallelism
    the layer runs on the rank's query heads over the image K/V of its kv
    heads (whole where they do not divide the model axis: its query heads
    then read their GQA group's one head, ``quant.surgery.kv_layout``);
    wo is row-parallel, and its all-reduce (in :func:`dense`) comes
    before ``tanh(gate)`` scales the output."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["wq"], x, "xattn.wq").reshape(B, S, -1, hd)
    q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = image_kv
    kv = _kv_read(cfg)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    msk = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
    o = sdpa(q, k, v, msk, 1.0 / math.sqrt(hd))
    return torch.tanh(p["gate"]).to(x.dtype) * dense(
        p["wo"], o.reshape(B, S, -1), "xattn.wo")


def image_kv(p, cfg, image_embeds):
    """Project the stubbed image patch embeddings (B, n_img, d) to one
    cross layer's (k, v), each (B, n_img, Hkv, D): k per-head RMS-normed,
    v as projected. Under tensor parallelism Hkv is the rank's kv heads,
    read from wk's width (its column shard, or whole)."""
    B, n_img, _ = image_embeds.shape
    hd = cfg.head_dim
    k = dense(p["wk"], image_embeds, "xattn.wk").reshape(B, n_img, -1, hd)
    k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    v = dense(p["wv"], image_embeds, "xattn.wv").reshape(B, n_img, -1, hd)
    return k, v


# --------------------------------------------------------------------------
# FFN — SwiGLU
# --------------------------------------------------------------------------


def ffn(p, x, prefix: str = "ffn", reduce: bool = True):
    """SwiGLU FFN; `prefix` names its taps (the MoE's shared experts tap
    under ``moe.shared``). ``reduce=False``: under a tensor-parallel mesh
    the row-parallel w_down's partial sums are returned unreduced
    (:func:`dense`)."""
    if _use_merged(p, "wgu", x):
        d_ff = p["wgu"]["qu_t"].shape[-1]   # gate/up share d_out
        g, u = dense_merged(p["wgu"], x, (d_ff, d_ff))
    else:
        g = dense(p["w_gate"], x, prefix + ".w_gate")
        u = dense(p["w_up"], x, prefix + ".w_up")
    return dense(p["w_down"], silu(g) * u, prefix + ".w_down", reduce)


# --------------------------------------------------------------------------
# MoE — sort-based capacity dispatch (served) + dense oracle (tests)
# --------------------------------------------------------------------------


def _matmul_f32(a, b):
    """a @ b in full f32: TF32 stays off for this product whatever the
    process has set (the router's logits decide which experts run)."""
    flags = torch.backends.cuda.matmul
    if not (a.is_cuda and flags.allow_tf32):
        return a @ b
    flags.allow_tf32 = False
    try:
        return a @ b
    finally:
        flags.allow_tf32 = True


def _route(p, cfg, xf):
    """Router in f32: softmax over the experts, the top k weights
    renormalised. Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them (a stable descending sort). Returns (topw (T, k) f32,
    topi (T, k) int64, probs (T, E))."""
    logits = _matmul_f32(xf.float(), p["router"]["w"].float())   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_tok
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, topi, probs


def _dispatch(xf, topw, topi, E: int, capacity: int, lo: int = 0,
              n_local: Optional[int] = None):
    """Sort-based capacity dispatch of t tokens. xf (t, d); topw/topi
    (t, k). The (token, choice) pairs are sorted by expert (stable, so
    earlier tokens first); pair j of expert e takes row j of its buffer
    while j < capacity, else the trash row. Only experts lo .. lo +
    n_local - 1 (all E by default) get buffers: a pair routed elsewhere
    is not kept here. Returns (buf (n_local, capacity, d), dest, st, sw,
    keep)."""
    t, d = xf.shape
    k = topi.shape[-1]
    dev = xf.device
    n_local = E if n_local is None else n_local
    flat_e = topi.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], topw.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[se]
    keep = rank < capacity
    if n_local != E:
        keep = keep & (se >= lo) & (se < lo + n_local)
    dest = torch.where(keep, (se - lo) * capacity + rank,
                       torch.full_like(se, n_local * capacity))  # trash
    buf = xf.new_zeros((n_local * capacity + 1, d))
    buf[dest] = xf[st] * keep[:, None].to(xf.dtype)
    return buf[:n_local * capacity].reshape(n_local, capacity, d), dest, \
        st, sw, keep


def _combine(ob, dest, st, sw, keep, t: int):
    """(E·capacity, d) expert outputs -> (t, d): each kept pair's row
    times its routing weight, summed per token (dropped pairs add 0)."""
    ob = torch.cat([ob, ob.new_zeros((1, ob.shape[-1]))])
    contrib = ob[dest] * (sw * keep).to(ob.dtype)[:, None]
    return ob.new_zeros((t, ob.shape[-1])).index_add_(0, st, contrib)


def _expert_range(p, cfg):
    """(first expert, experts held) of the routed stacks in `p`: all E,
    or under a tensor-parallel mesh this rank's block of E / N experts
    (``sharding.rules``: the stacks split on E, each expert whole)."""
    lin = p["w_gate"]
    held = next(lin[k] for k in ("qu_t", "w", "lu") if k in lin).shape[0]
    if held == cfg.n_experts:
        return 0, held
    mesh = kops.current_kernel_policy().mesh
    if mesh is None:
        raise ValueError(f"the expert stacks hold {held} of "
                         f"{cfg.n_experts} experts, and the kernel policy "
                         f"in force carries no mesh")
    return mesh.tp_rank * held, held


def moe(p, cfg, x, capacity: Optional[int] = None):
    """Capacity-bounded sort-based MoE over the B·S rows of the call, one
    dispatch group (the JAX package groups by its data-parallel degree,
    which is 1 on one card): route, dispatch into an (E, capacity, d)
    buffer, the three expert linears (each one launch of kernel #1 over
    all E experts), combine, plus the shared experts' FFN when present.
    A token routed to an expert past its capacity loses that expert's
    contribution.

    Expert-parallel under a tensor-parallel mesh (the reference's
    ``_shard_launch`` over the expert axis, made explicit): every rank
    routes all the rows with the replicated f32 router and sorts the same
    pairs, so capacity and drops are the unsharded layer's; it buffers
    only the pairs of its own E / N experts, launches #1 over its local
    stacks (G = E / N) and combines their rows. The shared experts'
    row-parallel partial joins that partial sum, and ONE all-reduce
    finishes the layer, as one finishes a dense FFN. The routed w_down is
    never all-reduced on its own: its rows are whole experts, not a d_in
    shard."""
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    xf = x.reshape(T, d)
    topw, topi, _ = _route(p, cfg, xf)
    if capacity is None:
        # rows per expert: ceil(T·k/E · capacity factor) rounded up to a
        # multiple of 8, at least 8; T counts pad rows and idle slots too
        capacity = int(math.ceil(T * cfg.n_experts_per_tok / E
                                 * cfg.capacity_factor))
        capacity = max(8, -(-capacity // 8) * 8)
    lo, held = _expert_range(p, cfg)
    eb, dest, st, sw, keep = _dispatch(xf, topw, topi, E, capacity, lo,
                                       held)
    h = silu(dense_expert(p["w_gate"], eb, "moe.w_gate")) \
        * dense_expert(p["w_up"], eb, "moe.w_up")
    ob = dense_expert(p["w_down"], h, "moe.w_down")   # (held, capacity, d)
    y = _combine(ob.reshape(held * capacity, d), dest, st, sw, keep, T)
    y = y.reshape(B, S, d).to(x.dtype)
    parallel = held != E
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], x, "moe.shared", reduce=not parallel)
    return kops.finish_row_parallel(y) if parallel else y


def moe_dense_oracle(p, cfg, x):
    """Reference: every expert on every token, weighted by the router's
    renormalised top-k (no capacity; tests only, FP experts)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    topw, topi, _ = _route(p, cfg, xf)
    w_full = torch.zeros((xf.shape[0], cfg.n_experts), dtype=torch.float32,
                         device=x.device).scatter(1, topi, topw)
    h = torch.einsum("td,edf->tef", xf, p["w_gate"]["w"].to(xf.dtype))
    u = torch.einsum("td,edf->tef", xf, p["w_up"]["w"].to(xf.dtype))
    o = torch.einsum("tef,efd->ted", silu(h) * u,
                     p["w_down"]["w"].to(xf.dtype))
    y = torch.einsum("ted,te->td", o, w_full.to(o.dtype)).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], x)
    return y


# --------------------------------------------------------------------------
# Mamba2 (SSD): the chunked parallel form and the O(1) recurrent step
# --------------------------------------------------------------------------


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``: max(x, 0) + log1p(exp(-|x|)))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """Depthwise causal conv as K shifted adds: x (B, S, C), w (K, C).
    The taps are summed in f32 in order, the bias last, and the sum cast
    back to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + pad[:, i:i + S].float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked state-space-dual scan (Mamba2, arXiv:2405.21060), in f32.

    xh: (B, S, H, P), dt: (B, S, H) (after softplus), A: (H,) negative,
    Bm / Cm: (B, S, G, N). S is zero-padded up to a multiple of the
    chunk (``min(chunk, S)``): a padded step has dt = 0, so it neither
    decays the state nor adds to it. Returns (y (B, S, H, P), the final
    state (B, H, P, N))."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    S0 = S
    if S % L:
        pad = L - S % L
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S += pad
    nc = S // L
    xc = xh.reshape(Bsz, nc, L, H, P).float()
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc = Bm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, 3).float()
    Cc = Cm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, 3).float()

    dA_cs = torch.cumsum(dtc * A, dim=2)                        # (B,nc,L,H)
    # intra-chunk: decay exp(dA_cs[i] - dA_cs[j]) for j <= i. The upper
    # triangle is masked before the exp, not after: there diff > 0 and
    # exp(diff) overflows at a long chunk (mamba2-370m's 256), and the
    # reference's where-after-exp then gives 0 · inf = NaN gradients (its
    # values equal these)
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]    # (B,nc,L,L,H)
    tri = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    scores = torch.einsum("bclhn,bcmhn->bclmh", Cc, Bc)
    w_ij = scores * decay * dtc[:, :, None, :, :]               # dt_j factor
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w_ij, xc)
    # each chunk's state, decayed to the chunk's end
    seg = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc * (seg * dtc)[..., None],
                          xc)
    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                 # (B,nc,H)
    st = xc.new_zeros((Bsz, H, P, N))
    prevs = []
    for c in range(nc):
        prevs.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prevs = torch.stack(prevs, 1)                               # (B,nc,H,P,N)
    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           Cc * torch.exp(dA_cs)[..., None], prevs)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S0], st


def _mamba_streams(p, x):
    """The five input streams z, x, B, C, dt: every packed projection is
    one launch of kernel #1 (:func:`dense`). Whether dt's narrow
    projection is packed is the selection rule's call: at mamba2-370m's
    width it stays FP (1024 -> 32, under min_dim 48), at zamba2-1.2b's it
    is packed (2048 -> 64), like the other five."""
    return (dense(p["wz"], x, "mixer.wz"), dense(p["wx"], x, "mixer.wx"),
            dense(p["wB"], x, "mixer.wB"), dense(p["wC"], x, "mixer.wC"),
            dense(p["wdt"], x, "mixer.wdt"))


def _conv_step(buf, new, w, b):
    """One-token depthwise causal conv from a (B, K-1, C) ring buffer,
    oldest row first. new: (B, 1, C). Returns (y (B, C) f32 before the
    activation, the next buffer)."""
    cat = torch.cat([buf, new.to(buf.dtype)], dim=1)            # (B, K, C)
    y = (cat.float() * w.float()[None]).sum(1) + b.float()
    return y, cat[:, 1:]


def _ssd_heads(cfg, H: int) -> Optional[slice]:
    """The SSD heads a mixer of `H` held heads runs: None for all of
    ``cfg.ssm_heads``, or under a tensor-parallel mesh this rank's block
    ``[r·H, (r+1)·H)`` (``sharding.rules``: wz / wx split on d_out by
    whole heads, the state on its head axis)."""
    if H == cfg.ssm_heads:
        return None
    mesh = kops.current_kernel_policy().mesh
    if mesh is None:
        raise ValueError(f"the mixer holds {H} of {cfg.ssm_heads} SSD heads, "
                         f"and the kernel policy in force carries no mesh")
    return slice(mesh.tp_rank * H, (mesh.tp_rank + 1) * H)


def _gated_norm(y, w, eps: float, width: int, sharded: bool):
    """The mixer's RMS norm of y (..., C) over the full d_inner `width`.
    With `sharded` y holds this rank's C = width / N columns: the f32 sum
    of squares is all-reduced over the model axis, so every rank divides
    the whole row's sum by the full width, as the unsharded norm does."""
    if not sharded:
        return rms_norm(y, w, eps)
    yf = y.float()
    ss = kops.finish_row_parallel((yf * yf).sum(dim=-1, keepdim=True))
    return (yf * torch.rsqrt(ss / width + eps) * w.float()).to(y.dtype)


def mamba2(p, cfg, x, state=None):
    """Mamba2 mixer. Returns (out, new state), the state as dict(ssm=(B,
    H, P, N) f32, conv_x / conv_B / conv_C = (B, K-1, C) rings in x's
    dtype, oldest row first), in new tensors (the caller commits them).
    state None: the full sequence through the chunked SSD; the new state
    is the terminal one (the reference's ``transformer._mamba_prefill``):
    the SSD's final state, and each ring the stream's last K-1 rows before
    the conv, a prompt shorter than K-1 right-aligned behind zeros, which
    is what the causal conv's zero padding sees (the reference writes its
    n rows at rows [0, n), ROADMAP §3). Otherwise the single-token
    recurrent step (S == 1) from ``state``. Rounding points are the
    reference's: each conv sum cast to x's dtype on the full route (f32
    into the step's activation), the scan and the state in f32, y cast to
    x's dtype before the gated norm.

    Under tensor parallelism the mixer runs on the rank's SSD heads, read
    from wx's width (:func:`_ssd_heads`): z and x come from the column
    shards of wz / wx, with conv_x, its bias and norm_w on the same
    d_inner columns, and the state holds those heads. B, C and dt come
    out of the whole wB / wC / wdt on every rank; dt, A_log, D and dt_bias
    are cut to the rank's heads here, once, and B / C after their groups
    are repeated out to heads, so that each head meets its own group. The
    gated norm spans all of d_inner, so its sum of squares is all-reduced
    (:func:`_gated_norm`) before out_proj runs row-parallel and its
    all-reduce (in :func:`dense`) sums the ranks' partials."""
    B, S, _ = x.shape
    P, g, n = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xs, Bm, Cm, dt = _mamba_streams(p, x)
    di = xs.shape[-1]                   # the rank's d_inner shard under TP
    H = di // P
    heads = _ssd_heads(cfg, H)
    A_log, D, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    if heads is not None:
        dt, A_log, D, dt_bias = (t[..., heads] for t in (dt, A_log, D,
                                                         dt_bias))
    dt = softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log.float())                               # (H,) < 0

    def per_head(m, *lead, expand=heads is not None):
        """(..., g·n) -> (..., H, n): each held head's group, or with
        `expand` off the (..., g, n) groups (the scan repeats them out
        itself)."""
        m = m.reshape(*lead, g, n)
        if not expand:
            return m
        m = m.repeat_interleave(cfg.ssm_heads // g, -2)
        return m if heads is None else m[..., heads, :]

    if state is None:
        K1 = cfg.ssm_conv - 1
        new_state = {k: F.pad(t[:, -K1:], (0, 0, max(0, K1 - S), 0))
                     for k, t in (("conv_x", xs), ("conv_B", Bm),
                                  ("conv_C", Cm))}
        xs = silu(_causal_conv(xs, p["conv_x"], p["conv_bx"]))
        Bm = silu(_causal_conv(Bm, p["conv_B"], p["conv_bB"]))
        Cm = silu(_causal_conv(Cm, p["conv_C"], p["conv_bC"]))
        xs = xs.reshape(B, S, H, P)
        y, new_state["ssm"] = ssd_chunked(
            xs, dt, A, per_head(Bm, B, S), per_head(Cm, B, S), cfg.ssm_chunk)
        y = y + D.float()[None, None, :, None] * xs.float()
    else:
        xs1, cx = _conv_step(state["conv_x"], xs, p["conv_x"], p["conv_bx"])
        Bm1, cB = _conv_step(state["conv_B"], Bm, p["conv_B"], p["conv_bB"])
        Cm1, cC = _conv_step(state["conv_C"], Cm, p["conv_C"], p["conv_bC"])
        xs = silu(xs1).reshape(B, H, P)
        Bm = per_head(silu(Bm1), B, expand=True)
        Cm = per_head(silu(Cm1), B, expand=True)
        dt1 = dt[:, 0]                                          # (B, H)
        dA = torch.exp(dt1 * A[None, :])
        ssm = state["ssm"] * dA[:, :, None, None] + \
            (dt1[:, :, None] * Bm)[:, :, None, :] * xs[:, :, :, None]
        y = torch.einsum("bhn,bhpn->bhp", Cm, ssm)
        y = y + D.float()[None, :, None] * xs
        y = y[:, None]                                          # (B,1,H,P)
        new_state = {"ssm": ssm, "conv_x": cx, "conv_B": cB, "conv_C": cC}
    y = y.reshape(B, S, di).to(x.dtype)
    y = _gated_norm(y * silu(z), p["norm_w"], cfg.norm_eps, cfg.d_inner,
                    heads is not None)
    return dense(p["out_proj"], y, "mixer.out_proj"), new_state
