"""Plain PyTorch oracles for the NanoQuant binary kernels — the twins of
``repro.kernels.ref``, and the plain versions every CUDA kernel of
:mod:`repro_torch.kernels` is held against.

Packing convention (paper Fig. 2c): a ±1 matrix ``A`` of shape (K, N)
is packed along axis 0 in groups of 32 rows into a 32-bit word array of
shape (K//32, N); bit ``b`` of word ``i`` stores ``A[i*32+b] > 0`` (so
-1 -> 0, +1 -> 1). PyTorch cannot shift ``uint32`` tensors on every
build, so the port keeps packed words as ``int32`` with the same bits:
``(w >> b) & 1`` is exact for any ``b`` despite the sign extension of
an arithmetic shift.
"""
from __future__ import annotations

from typing import Optional

import torch


def pack_signs(a: torch.Tensor) -> torch.Tensor:
    """(..., K, N) ±1/float -> (..., K//32, N) int32 words; leading dims
    (stacked experts) pack each matrix alike. K must be a multiple of
    32."""
    *lead, K, N = a.shape
    if K % 32:
        raise ValueError(f"pack dim {K} not a multiple of 32")
    bits = (a > 0).to(torch.int64).reshape(*lead, K // 32, 32, N)
    shifts = torch.arange(32, dtype=torch.int64, device=a.device)
    words = (bits << shifts[:, None]).sum(dim=-2)           # < 2**32
    words = words - ((words >> 31) & 1) * (1 << 32)         # wrap to int32
    return words.to(torch.int32)


# the bits of float32 -1.0 (0xBF800000) as an int32
_NEG_ONE_BITS = -0x40800000


def unpack_signs(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., K//32, N) int32 words -> (..., K, N) in {-1, +1}; leading
    dims (stacked experts) unpack each matrix alike. Each sign is built
    as float32 bits in place: bit b of a word moved to the sign position
    and xor-ed into -1.0's bits, so a set bit gives +1.0 (three passes
    over the output, then a cast for another dtype)."""
    *lead, n32, N = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = packed[..., :, None, :] >> shifts[:, None]
    bits.bitwise_left_shift_(31).bitwise_xor_(_NEG_ONE_BITS)
    signs = bits.view(torch.float32).reshape(*lead, n32 * 32, N)
    return signs if dtype == torch.float32 else signs.to(dtype)


def packed_matmul_ref(x, packed_w, s_k=None, s_n=None, *, out_dtype=None):
    """y = (x ⊙ s_k) @ unpack(packed_w) ⊙ s_n with an f32 accumulator;
    the result rounds to x's dtype (``repro.kernels.ref.
    packed_matmul_ref``), or to ``out_dtype`` when given. x: (..., K)."""
    w = unpack_signs(packed_w, torch.float32)
    xf = x
    if s_k is not None:
        xf = xf * s_k.to(x.dtype)
    y = torch.matmul(xf.float(), w)
    if s_n is not None:
        y = y * s_n.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)


def lowrank_binary_matmul_ref(x, qv, qu_t, s1, s2):
    """NanoQuant linear (paper Eq. 1): y = s1 ⊙ ((x ⊙ s2) @ V±1) @ U±1ᵀ.

    Two-stage form: the rank-r intermediate rounds to the activation
    dtype between stages, as the pre-fusion two-kernel execution does.
    x: (..., d_in); qv: (d_in//32, r); qu_t: (r//32, d_out)."""
    t = packed_matmul_ref(x, qv, s_k=s2)
    return packed_matmul_ref(t, qu_t, s_n=s1)


def lowrank_binary_matmul_fused_ref(x, qv, qu_t, s1, s2, rmask=None,
                                    eff_rank: Optional[int] = None):
    """Oracle of the fused kernel: the whole chain runs with an f32
    intermediate. rmask: optional (r,) zeroing padded rank columns of a
    merged group; eff_rank: optional R' <= r (multiple of 32) — only the
    leading R' rank columns take part (slices, no repack). Leading dims
    (groups) of the operands batch the chain, x broadcasting over them."""
    if eff_rank is not None:
        r_full = qv.shape[-1]
        if not (0 < eff_rank <= r_full and eff_rank % 32 == 0):
            raise ValueError(
                f"eff_rank must be a multiple of 32 in (0, {r_full}], "
                f"got {eff_rank}")
        qv = qv[..., :eff_rank]
        qu_t = qu_t[..., :eff_rank // 32, :]
        if rmask is not None:
            rmask = rmask[..., :eff_rank]
    v = unpack_signs(qv, torch.float32)
    u = unpack_signs(qu_t, torch.float32)
    t = torch.matmul(x.float() * s2.float(), v)
    if rmask is not None:
        t = t * rmask.float()
    y = torch.matmul(t, u)
    return (y * s1.float()).to(x.dtype)


def _floor_mod(a, n):
    """Python/jnp ``%`` (result has the sign of n) on integer tensors."""
    return torch.remainder(a, n)


def paged_attention_ref(q, k_pool, v_pool, block_table, q_pos, cache_pos,
                        window: int = 0, scale: float = 1.0):
    """Gather-attention decode oracle over a paged KV pool.

    q: (B, S, Hq, D); k_pool / v_pool: (n_pages, page_size, Hkv, D);
    block_table: (B, pages) int32 (unmapped entries -> null page 0);
    q_pos / cache_pos: (B,) of the first query. Query j (absolute
    position q_pos + j) sees virtual row r as absolute position
    ``(q_pos + j) - ((cache_pos + j - r) mod rows)``; negative means
    never written, and ``window`` masks positions past the sliding
    window. Masked scores are -1e30, so the softmax underflows them to
    exactly 0. Returns (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    bt = block_table.long()
    k = k_pool[bt].reshape(B, -1, *k_pool.shape[2:])          # (B, V, Hkv, D)
    v = v_pool[bt].reshape(B, -1, *v_pool.shape[2:])
    rows = k.shape[1]
    dev = q.device
    r = torch.arange(rows, device=dev)
    j = torch.arange(S, device=dev)
    qp = q_pos.long()[:, None] + j[None, :]                   # (B, S)
    cp = cache_pos.long()[:, None] + j[None, :]
    abs_pos = qp[:, :, None] - _floor_mod(cp[:, :, None] - r, rows)
    m = abs_pos >= 0                                          # (B, S, V)
    if window:
        m = m & (abs_pos > qp[:, :, None] - window)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    s = torch.where(m[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, S, Hq, D)


def _rope_ref(x, pos, theta: float):
    """Rotate-half RoPE on (B, H, D) at per-slot positions (B,) — f32
    trig, result cast back to x's dtype."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[:, None, None] * inv[None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def decode_step_ref(x, mqkv, wo, k_pool, v_pool, block_table, q_pos,
                    cache_pos, *, head_dim: int, dims, theta: float,
                    scale: float, window: int = 0,
                    eff_rank: Optional[int] = None,
                    eff_rank_o: Optional[int] = None):
    """Oracle of the decode-step megakernel: merged-QKV packed matmul →
    RoPE → fresh-KV paged attention → packed output projection, with the
    roundings of the unfused chain (projections round to x's dtype, the
    fresh k/v to the pool dtype before scoring).

    x: (B, K); mqkv: merged group (qv (3, K//32, R), qu_t (3, R//32,
    Nmax), s1, s2, rmask); wo: packed output projection; dims: (Hq*D,
    Hkv*D). The pools are not modified. Returns (y (B, d_model),
    k_new (B, Hkv, D), v_new (B, Hkv, D)), k_new/v_new in the pool
    dtype."""
    B = x.shape[0]
    nq, nkv = dims
    hq, hkv = nq // head_dim, nkv // head_dim
    rmask = mqkv.get("rmask")
    outs = []
    for g, n in enumerate((nq, nkv, nkv)):
        y = lowrank_binary_matmul_fused_ref(
            x, mqkv["qv"][g], mqkv["qu_t"][g], mqkv["s1"][g],
            mqkv["s2"][g], None if rmask is None else rmask[g],
            eff_rank=eff_rank)
        outs.append(y[:, :n])
    q = _rope_ref(outs[0].reshape(B, hq, head_dim), q_pos, theta)
    k_new = _rope_ref(outs[1].reshape(B, hkv, head_dim), q_pos, theta)
    k_new = k_new.to(k_pool.dtype)
    v_new = outs[2].reshape(B, hkv, head_dim).to(v_pool.dtype)

    # write the fresh row (into copies), then attend: the unfused order
    ps = k_pool.shape[1]
    rows = block_table.shape[1] * ps
    rowv = _floor_mod(cache_pos.long(), rows)
    page = block_table.long().gather(1, (rowv // ps)[:, None])[:, 0]
    kp = k_pool.clone()
    vp = v_pool.clone()
    kp[page, rowv % ps] = k_new
    vp[page, rowv % ps] = v_new
    o = paged_attention_ref(q[:, None], kp, vp, block_table, q_pos,
                            cache_pos, window=window, scale=scale)
    xo = o.reshape(B, nq).to(x.dtype)
    ko = wo["qv"].shape[0] * 32          # stored K may be pack-aligned
    if ko != nq:                         # past Hq*D; padded s2 cols are 0
        xo = torch.nn.functional.pad(xo, (0, ko - nq))
    y = lowrank_binary_matmul_fused_ref(
        xo, wo["qv"], wo["qu_t"], wo["s1"], wo["s2"], eff_rank=eff_rank_o)
    return y, k_new, v_new
