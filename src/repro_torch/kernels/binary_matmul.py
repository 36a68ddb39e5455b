"""Packed binary matmuls: two CUDA kernels, their wrappers and their
plain versions.

- :func:`fused_lowrank_matmul_grouped` — ``csrc/binary_matmul.cu``,
  replacing the TPU kernel
  ``repro/kernels/binary_matmul.py::fused_lowrank_matmul_grouped``. For G
  groups in one launch:
  ``y_g = s1_g ⊙ ((((x ⊙ s2_g) @ V±1_g) ⊙ rmask_g) @ U±1ᵀ_g)`` with the
  rank-r intermediate in f32, never written to device memory. x is shared
  by the groups (merged QKV / gate-up) or given per group. ``eff_rank``
  reads only the leading R' rank columns of the full packed operands.
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
_CLUSTER = 8                # blocks per cluster (CL / MAX_KS in the kernels)
_COLS_PER_BLOCK = 128       # stage-2 columns a block covers at the least
_PM_COLS = 256              # packed_matmul: output columns per block (BN)
_PM_CHUNK_WORDS = 8         # packed_matmul: words per K chunk (KC / 32)
_GRID_YZ_MAX = 65535


def fused_lowrank_matmul_grouped_ref(xg, qv_g, qu_g, s1_g, s2_g,
                                     rmask_g=None, *, x_shared=False,
                                     eff_rank: Optional[int] = None):
    """Plain version: ``ref.lowrank_binary_matmul_fused_ref`` per group."""
    return torch.stack([
        ref.lowrank_binary_matmul_fused_ref(
            xg[0 if x_shared else g], qv_g[g], qu_g[g], s1_g[g], s2_g[g],
            None if rmask_g is None else rmask_g[g], eff_rank=eff_rank)
        for g in range(qv_g.shape[0])])


def _n_split(G: int, m_tiles: int, N: int) -> int:
    """N-slices per (group, M-tile), a multiple of the cluster size: one
    cluster, or more (each recomputing stage 1) while the grid is short
    of two waves over the SMs and every slice keeps at least
    _COLS_PER_BLOCK columns."""
    want = math.ceil(2 * _SMS / (G * m_tiles * _CLUSTER))
    cap = math.ceil(N / (_CLUSTER * _COLS_PER_BLOCK))
    return _CLUSTER * max(1, min(want, cap))


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
    m_tiles = -(-M // 8)
    lib = build.library("binary_matmul")
    fn = lib.nq_fused_lowrank
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(build.ptr(xg), 0 if x_shared else M * K, build.ptr(qv_g),
             build.ptr(qu_g), build.ptr(s1_g), build.ptr(s2_g),
             build.ptr(rmask_g), build.ptr(out), G, M, K, R, r_eff, N,
             _n_split(G, m_tiles, N), code, build.current_stream(xg.device))
    build.check_launch(name, err)
    fused_lowrank_matmul_grouped.launches += 1
    return out


fused_lowrank_matmul_grouped.launches = 0


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


def _rows_per_block(M: int) -> int:
    """Activation rows per block (BM in the kernel): the smallest of 1,
    2, 4, 8 that covers a decode batch, 8 from 5 rows on."""
    return next(b for b in (1, 2, 4, 8) if M <= b or b == 8)


def _k_split(tiles: int, kw: int) -> int:
    """K-split blocks per output tile, one cluster of at most _CLUSTER:
    enough for about two blocks per SM when the output tiles alone fall
    short, each split keeping at least one K chunk and none empty."""
    want = -(-2 * _SMS // tiles)
    ks = max(1, min(_CLUSTER, want, kw // _PM_CHUNK_WORDS))
    per = -(-kw // ks)
    return -(-kw // per)


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
    bm = _rows_per_block(M)
    m_tiles, n_tiles = -(-M // bm), -(-N // _PM_COLS)
    if max(m_tiles, n_tiles) > _GRID_YZ_MAX:
        raise ValueError(f"{name}: ({M}, {N}) needs more than "
                         f"{_GRID_YZ_MAX} tiles along a grid axis")
    ks = _k_split(m_tiles * n_tiles, KW)
    fn = build.library("packed_matmul").nq_packed_matmul
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    none = ctypes.c_void_p(None)
    err = fn(build.ptr(x), build.ptr(packed_w), packed_w.stride(0),
             none if s_k is None else build.ptr(s_k),
             none if s_n is None else build.ptr(s_n), build.ptr(out),
             M, K, N, ks, bm, in_code, out_code,
             build.current_stream(x.device))
    build.check_launch(name, err)
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0


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
