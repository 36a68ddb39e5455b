"""Fused grouped low-rank binary matmul: the CUDA kernel
``csrc/binary_matmul.cu`` (replacing the TPU kernel
``repro/kernels/binary_matmul.py::fused_lowrank_matmul_grouped``), its
wrapper and its plain version.

For G groups in one launch:
``y_g = s1_g ⊙ ((((x ⊙ s2_g) @ V±1_g) ⊙ rmask_g) @ U±1ᵀ_g)`` with the
rank-r intermediate in f32, never written to device memory. x is shared
by the groups (merged QKV / gate-up) or given per group. ``eff_rank``
reads only the leading R' rank columns of the full packed operands.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# ranks above this run the two-call path in the JAX package (its Pallas
# kernel packed_matmul, not ported yet)
MAX_FUSED_RANK = 4096
_SMS = 132                  # H100 SXM streaming multiprocessors
_CLUSTER = 8                # blocks per cluster (CL in the kernel)
_COLS_PER_BLOCK = 128       # stage-2 columns a block covers at the least


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
