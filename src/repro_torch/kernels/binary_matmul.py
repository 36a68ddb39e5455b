"""Packed binary matmuls: two CUDA kernels, their wrappers and their
plain versions.

Both kernels do their ±1 products on the tensor cores through one tile
routine (``csrc/binary_mma.cuh``): the packed factor is expanded from its
words into exact bf16 ±1 operands in registers, and an f32 operand is
split into bf16 terms (:func:`split_bf16`, three for an f32 result, two
for a bf16 one) whose products are summed in f32.

- :func:`fused_lowrank_matmul_grouped` — ``csrc/binary_matmul.cu``,
  replacing the TPU kernel
  ``repro/kernels/binary_matmul.py::fused_lowrank_matmul_grouped``. For G
  groups in one launch:
  ``y_g = s1_g ⊙ ((((x ⊙ s2_g) @ V±1_g) ⊙ rmask_g) @ U±1ᵀ_g)`` with the
  rank-r intermediate in f32. One cooperative launch of co-resident
  blocks computes stage 1 once per (group, M-tile, rank tile, K slice),
  writes the f32 partial sums to a workspace in device memory (L2-sized
  at decode), and after a grid barrier sums them in slice order for
  stage 2 (:func:`_plan_fused`). x is shared by the groups (merged QKV /
  gate-up) or given per group. ``eff_rank`` reads only the leading R'
  rank columns of the full packed operands.
- :func:`packed_matmul` — ``csrc/packed_matmul.cu``, replacing the TPU
  kernel ``repro/kernels/binary_matmul.py::packed_matmul``:
  ``y = ((x ⊙ s_k) @ W±1) ⊙ s_n`` for one packed matrix. Two launches of
  it make :func:`lowrank_binary_matmul_twocall`, the path for ranks past
  :data:`MAX_FUSED_RANK` and for ``KernelPolicy(fused=False)``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# ranks above this run the two-call path (packed_matmul twice), as in
# the JAX package; read at call time, so tests can lower it
MAX_FUSED_RANK = 4096
_SMS = 132                  # H100 SXM streaming multiprocessors
_CLUSTER = 8                # packed_matmul: K-split blocks per cluster (MAX_KS)
_TILE_COLS = 128            # output columns per block tile (BN in binary_mma.cuh)
_TILE_ROWS = (8, 16, 32, 64)  # activation rows per block tile (8 * MT)
_MIN_SLICE_WORDS = 8        # fused stage 1: packed words per K slice at the least
_GRID_YZ_MAX = 65535
INSTRUCTION = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"


def split_bf16(v, terms: int):
    """f32 ``v`` as ``terms`` bf16 tensors (hi, mid, lo) whose f32 sum
    rebuilds it: each term rounds what the earlier ones left. Three terms
    carry all 24 bits of an f32 mantissa, so they rebuild a normal value
    exactly; the kernels split their f32 operands this way."""
    out, rest = [], v.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return out


def _chunk_words(bm: int) -> int:
    """Packed words per staged K chunk for a row tile of bm rows
    (chunk_words in binary_mma.cuh)."""
    return max(2, 128 // bm)


def _tile_rows(M: int) -> int:
    """Rows per block tile: the smallest of 8, 16, 32, 64 that covers M,
    64 past it (an n8 tile of the mma is the least a decode row takes)."""
    return next(b for b in _TILE_ROWS if M <= b or b == _TILE_ROWS[-1])


def _terms(x_dtype, out_dtype) -> int:
    """bf16 terms per activation value: 3 for an f32 operand into an f32
    result, 2 into a bf16 one, 1 for a bf16 operand (exact)."""
    if x_dtype == torch.bfloat16:
        return 1
    return 3 if out_dtype == torch.float32 else 2


def _plan_fused(G: int, M: int, K: int, r_eff: int, N: int, blocks: int, *,
                terms: int = 3) -> dict:
    """The fused kernel's launch plan. ``blocks``: how many blocks fit on
    the card at once (the occupancy query times the SMs); the grid is
    never larger, so its grid-wide barriers cannot deadlock.

    Stage 1 items are (group, M-tile, rank tile, K slice), each computed
    once; K slices (at least _MIN_SLICE_WORDS words each, none empty)
    are added while the items fall short of ``blocks``, which happens at
    decode. Stage 2 items are (group, M-tile, output tile). The workspace
    holds x ⊙ s2 as bf16 terms, the f32 partial sums of every slice and
    the split intermediate, in bytes."""
    bm = _tile_rows(M)
    kw = K // 32
    m_tiles = -(-M // bm)
    r_tiles = -(-r_eff // _TILE_COLS)
    n_tiles = -(-N // _TILE_COLS)
    base = G * m_tiles * r_tiles
    want = max(1, min(blocks // base, kw // _MIN_SLICE_WORDS))
    kw_per_slice = -(-kw // want)
    slices = -(-kw // kw_per_slice)
    stage1, stage2 = base * slices, G * m_tiles * n_tiles
    partial_bytes = 4 * G * slices * M * r_eff
    return {"blocks": blocks, "bm": bm, "m_tiles": m_tiles,
            "r_tiles": r_tiles, "n_tiles": n_tiles, "slices": slices,
            "kw_per_slice": kw_per_slice, "stage1_items": stage1,
            "stage2_items": stage2, "terms": terms,
            "grid": max(1, min(blocks, max(stage1, stage2))),
            "partial_bytes": partial_bytes,
            "workspace_bytes": 2 * G * terms * M * (K + r_eff)
            + partial_bytes}


_blocks_cache: dict = {}


def _coresident_blocks(lib, bm: int, rows: int, code: int) -> int:
    """Blocks of the fused kernel at row tile bm, ``rows`` = min(bm, M)
    rows and dtype code that fit on the current card at once (the
    occupancy query times the SMs), cached."""
    key = (bm, rows, code)
    if key not in _blocks_cache:
        n = ctypes.c_int(0)
        fn = lib.nq_fused_lowrank_blocks
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        build.check_launch("fused_lowrank_matmul_grouped occupancy",
                           fn(bm, rows, code, ctypes.byref(n)))
        _blocks_cache[key] = n.value
    return _blocks_cache[key]


def _aligned(t):
    """t itself when its data is 16-byte aligned (the kernels copy it in
    16-byte pieces), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_lowrank_matmul_grouped_ref(xg, qv_g, qu_g, s1_g, s2_g,
                                     rmask_g=None, *, x_shared=False,
                                     eff_rank: Optional[int] = None):
    """Plain version: ``ref.lowrank_binary_matmul_fused_ref`` per group."""
    return torch.stack([
        ref.lowrank_binary_matmul_fused_ref(
            xg[0 if x_shared else g], qv_g[g], qu_g[g], s1_g[g], s2_g[g],
            None if rmask_g is None else rmask_g[g], eff_rank=eff_rank)
        for g in range(qv_g.shape[0])])


def fused_lowrank_matmul_grouped(xg, qv_g, qu_g, s1_g, s2_g, rmask_g=None,
                                 *, x_shared: bool = False,
                                 eff_rank: Optional[int] = None):
    """One fused pass over G grouped low-rank binary linears.

    xg: (Gx, M, K) f32/bf16 — Gx == 1 with ``x_shared`` else G;
    qv_g: (G, K//32, R) int32 words; qu_g: (G, R//32, N) int32 words;
    s1_g: (G, N), s2_g: (G, K), rmask_g: (G, R) f32 (None = all ranks
    real); eff_rank: optional R' <= R, a multiple of 32. Returns
    (G, M, N) in xg's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel (and raise on anything it does not take).
    """
    Gx, M, K = xg.shape
    G, KW, R = qv_g.shape
    N = qu_g.shape[2]
    if KW * 32 != K or qu_g.shape[:2] != (G, R // 32) or R % 32:
        raise ValueError(f"packed operands {tuple(qv_g.shape)} / "
                         f"{tuple(qu_g.shape)} do not match x {tuple(xg.shape)}")
    if Gx != (1 if x_shared else G):
        raise ValueError(f"x has {Gx} groups, expected "
                         f"{1 if x_shared else G} (x_shared={x_shared})")
    if tuple(s1_g.shape) != (G, N) or tuple(s2_g.shape) != (G, K):
        raise ValueError(f"scales {tuple(s1_g.shape)} / {tuple(s2_g.shape)} "
                         f"do not match (G, N) = {(G, N)}, (G, K) = {(G, K)}")
    if rmask_g is not None and tuple(rmask_g.shape) != (G, R):
        raise ValueError(f"rmask {tuple(rmask_g.shape)} != {(G, R)}")
    r_eff = R if eff_rank is None else int(eff_rank)
    if not (0 < r_eff <= R and r_eff % 32 == 0):
        raise ValueError(f"eff_rank must be a multiple of 32 in (0, {R}], "
                         f"got {eff_rank}")
    if xg.device.type == "cpu":
        return fused_lowrank_matmul_grouped_ref(
            xg, qv_g, qu_g, s1_g, s2_g, rmask_g, x_shared=x_shared,
            eff_rank=eff_rank)
    name = "fused_lowrank_matmul_grouped"
    if rmask_g is None:
        rmask_g = torch.ones((G, R), dtype=torch.float32, device=xg.device)
    build.check_cuda(name, x=xg)
    build.check_cuda(name, torch.int32, qv=qv_g, qu=qu_g)
    build.check_cuda(name, torch.float32, s1=s1_g, s2=s2_g, rmask=rmask_g)
    build.check_cuda(name, x=xg, qv=qv_g, s1=s1_g)
    code = build.dtype_code(xg)
    out = torch.empty((G, M, N), dtype=xg.dtype, device=xg.device)
    if M == 0:
        return out
    lib = build.library("binary_matmul")
    bm = _tile_rows(M)
    plan = _plan_fused(G, M, K, r_eff, N,
                       _coresident_blocks(lib, bm, min(bm, M), code),
                       terms=_terms(torch.float32, xg.dtype))
    ws = torch.empty(plan["workspace_bytes"], dtype=torch.uint8,
                     device=xg.device)
    fn = lib.nq_fused_lowrank
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(build.ptr(xg), 0 if x_shared else M * K,
             build.ptr(qv_g), build.ptr(qu_g), build.ptr(s1_g),
             build.ptr(s2_g), build.ptr(rmask_g), build.ptr(out),
             build.ptr(ws), G, M, K, R, r_eff, N, plan["bm"],
             plan["slices"], plan["kw_per_slice"], plan["grid"], code,
             build.current_stream(xg.device))
    build.check_launch(name, err)
    fused_lowrank_matmul_grouped.launches += 1
    fused_lowrank_matmul_grouped.plan = plan
    return out


fused_lowrank_matmul_grouped.launches = 0
fused_lowrank_matmul_grouped.plan = None     # the last launch's plan


def fused_lowrank_matmul(x, qv, qu_t, s1, s2, *,
                         eff_rank: Optional[int] = None):
    """Single-linear form: x (..., d_in) -> (..., d_out) through the
    grouped launch with one group."""
    shape = x.shape
    y = fused_lowrank_matmul_grouped(
        x.reshape(1, -1, shape[-1]), qv[None], qu_t[None], s1[None],
        s2[None], x_shared=True, eff_rank=eff_rank)[0]
    return y.reshape(*shape[:-1], y.shape[-1])


# ---------------------------------------------------------------------------
# packed_matmul: one packed ±1 matrix (the two-call building block)
# ---------------------------------------------------------------------------

# plain version: the oracle, with the wrapper's out_dtype
packed_matmul_ref = ref.packed_matmul_ref


def _plan_packed(M: int, K: int, N: int, terms: int = 3) -> dict:
    """packed_matmul's launch plan: the row tile (bm), the output tiles,
    and ks, the K-split blocks per output tile (one cluster of at most
    _CLUSTER): enough for about four blocks per SM when the output tiles
    alone fall short, each split keeping at least one staged chunk and
    none empty. (Planning one wave of co-resident blocks instead was
    measured slower on the H100: more, shorter blocks hide more latency.)"""
    bm = _tile_rows(M)
    kw = K // 32
    m_tiles, n_tiles = -(-M // bm), -(-N // _TILE_COLS)
    want = -(-4 * _SMS // (m_tiles * n_tiles))
    ks = max(1, min(_CLUSTER, want, kw // _chunk_words(bm)))
    ks = -(-kw // max(1, -(-kw // ks)))      # none of the splits empty
    return {"bm": bm, "m_tiles": m_tiles, "n_tiles": n_tiles, "ks": ks,
            "kw_per_split": -(-kw // ks), "chunk_words": _chunk_words(bm),
            "terms": terms}


def packed_matmul(x, packed_w, s_k=None, s_n=None, *, out_dtype=None):
    """y = ((x ⊙ s_k) @ unpack(packed_w)) ⊙ s_n for one packed ±1 matrix.

    x: (M, K) f32/bf16; packed_w: (K//32, N) int32 words with unit column
    stride (its rows may be strided, so a column slice ``w[:, :N']`` of a
    wider matrix, an eff_rank view, is read in place); s_k: (K,) and s_n:
    (N,) f32, or None for ones. The sum is f32; the result is (M, N) in
    ``out_dtype`` (default x's dtype). CPU tensors take the plain
    version; CUDA tensors launch the kernel (and raise on anything it
    does not take)."""
    if x.dim() != 2 or packed_w.dim() != 2:
        raise ValueError(f"packed_matmul takes x (M, K) and words (K//32, "
                         f"N), got {tuple(x.shape)} / "
                         f"{tuple(packed_w.shape)}")
    M, K = x.shape
    KW, N = packed_w.shape
    if KW * 32 != K:
        raise ValueError(f"packed operand {tuple(packed_w.shape)} does not "
                         f"match x {tuple(x.shape)}")
    for nm, s, n in (("s_k", s_k, K), ("s_n", s_n, N)):
        if s is not None and tuple(s.shape) != (n,):
            raise ValueError(f"{nm} {tuple(s.shape)} != ({n},)")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return packed_matmul_ref(x, packed_w, s_k, s_n, out_dtype=out_dtype)
    name = "packed_matmul"
    scales = {nm: s for nm, s in (("s_k", s_k), ("s_n", s_n))
              if s is not None}
    build.check_cuda(name, x=x, **scales)
    build.check_cuda(name, torch.float32, **scales)
    if packed_w.device != x.device or packed_w.dtype != torch.int32:
        raise TypeError(f"{name}: packed_w must be int32 on {x.device}, got "
                        f"{packed_w.dtype} on {packed_w.device}")
    if N > 1 and packed_w.stride(1) != 1 or KW > 1 and packed_w.stride(0) < N:
        raise ValueError(f"{name}: packed_w needs unit column stride and a "
                         f"row stride >= N, got {packed_w.stride()}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    in_code, out_code = build.dtype_code(x), build.dtype_code(out)
    if M == 0 or N == 0:
        return out
    plan = _plan_packed(M, K, N, _terms(x.dtype, out_dtype))
    if max(plan["m_tiles"], plan["n_tiles"]) > _GRID_YZ_MAX:
        raise ValueError(f"{name}: ({M}, {N}) needs more than "
                         f"{_GRID_YZ_MAX} tiles along a grid axis")
    fn = build.library("packed_matmul").nq_packed_matmul
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    none = ctypes.c_void_p(None)
    err = fn(build.ptr(_aligned(x)), build.ptr(packed_w), packed_w.stride(0),
             none if s_k is None else build.ptr(_aligned(s_k)),
             none if s_n is None else build.ptr(s_n), build.ptr(out),
             M, K, N, plan["ks"], plan["bm"], in_code, out_code,
             build.current_stream(x.device))
    build.check_launch(name, err)
    packed_matmul.launches += 1
    packed_matmul.plan = plan
    return out


packed_matmul.launches = 0
packed_matmul.plan = None                    # the last launch's plan


def lowrank_binary_matmul_twocall(x, qv, qu_t, s1, s2):
    """y = s1 ⊙ ((x ⊙ s2) @ V±1) @ U±1ᵀ as two :func:`packed_matmul`
    launches, the rank intermediate written to device memory in x's dtype
    (the JAX package's two-call rounding; ``ref.lowrank_binary_matmul_ref``
    is its plain version). x: (..., K); qv: (K//32, r) words, possibly a
    column slice; qu_t: (r//32, N) words; s1: (N,), s2: (K,) f32."""
    shape = x.shape
    t = packed_matmul(x.reshape(-1, shape[-1]), qv, s_k=s2)
    y = packed_matmul(t, qu_t, s_n=s1)
    return y.reshape(*shape[:-1], y.shape[-1])
