"""Dense-family layers, the port of ``repro.models.layers``.

Params are plain dicts of tensors, as in the JAX package. Linear layers go
through :func:`dense`, which runs a full-precision matmul or a NanoQuant
packed low-rank binary matmul when the dict carries packed leaves. KV
caches are updated in place (the JAX package returns fresh arrays): the
engine owns one pool and every decode step writes into it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ops as kops

# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def dense(p: dict, x):
    """FP or packed-binary linear. x: (..., d_in) -> (..., d_out). A packed
    dict of a draft view (``quant.surgery.rank_truncated_view``) carries
    ``eff_rank``: the kernel then reads only the leading rank columns."""
    if "qu_t" in p:      # packed low-rank binary path (paper Eq. 1)
        y = kops.lowrank_binary_matmul(x, p["qv"], p["qu_t"], p["s1"],
                                       p["s2"], eff_rank=p.get("eff_rank"))
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
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


def _use_merged(p: dict, key: str, x) -> bool:
    return key in p and \
        kops.current_kernel_policy().use_merged_projections(x.device)


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


def attention(p, cfg, x, positions, cache=None, cache_pos=None,
              block_table=None):
    """GQA attention. Returns (out, cache).

    cache None: training / full-sequence forward. With a rectangular
    cache dict(k=(B, Smax, Hkv, D), v=...) and S > 1: prompt prefill at
    position 0 — the cache rows [0, S) are written and the prompt attends
    to itself. With ``block_table`` (B, pages): the cache is a paged pool
    (k/v: (n_pages, page_size, Hkv, D)) and this is a decode at per-slot
    rows ``cache_pos`` (B,), positions (B, S)."""
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
    if _use_merged(p, "wqkv", x):
        q, k, v = dense_merged(
            p["wqkv"], x,
            (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd))
        q = q.reshape(B, S, cfg.n_heads, hd)
        k = k.reshape(B, S, cfg.n_kv_heads, hd)
        v = v.reshape(B, S, cfg.n_kv_heads, hd)
    else:
        q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
        k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
        v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
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
        o = kops.paged_attention(q, cache["k"], cache["v"], block_table,
                                 positions[:, 0], cache_pos, window=window,
                                 scale=scale)
    else:
        if cache is not None:
            if S == 1 or cache_pos != 0:
                raise NotImplementedError(
                    "the rectangular cache serves the prompt prefill at "
                    "position 0; decode runs over the paged pool")
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        o = sdpa(q, k, v, _mask(positions, positions, window), scale)
    return dense(p["wo"], o.reshape(B, S, -1)), cache


# --------------------------------------------------------------------------
# FFN — SwiGLU
# --------------------------------------------------------------------------


def ffn(p, x):
    if _use_merged(p, "wgu", x):
        d_ff = p["wgu"]["qu_t"].shape[-1]   # gate/up share d_out
        g, u = dense_merged(p["wgu"], x, (d_ff, d_ff))
    else:
        g = dense(p["w_gate"], x)
        u = dense(p["w_up"], x)
    return dense(p["w_down"], silu(g) * u)
