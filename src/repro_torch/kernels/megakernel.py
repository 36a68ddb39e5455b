"""Decode-step megakernel: the CUDA kernel ``csrc/megakernel.cu``
(replacing the TPU kernel ``repro/kernels/megakernel.py::
decode_step_megakernel_raw``), its wrapper and its plain version
(``ref.decode_step_ref``).

One launch runs the attention half of a decode step for B slots:
merged-QKV packed matmul → RoPE at q_pos → page walk excluding the row
``== cache_pos`` → fold of the fresh k/v → normalise → packed wo. It
returns ``y`` plus the fresh ``k_new`` / ``v_new`` rows in the pool
dtype for the caller's paged cache write; the pools are only read.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref


def decode_step_megakernel_raw(x, mqkv, wo, k_pool, v_pool, block_table,
                               q_pos, cache_pos, *, dims, head_dim: int,
                               theta: float, scale: float, window: int = 0,
                               eff_rank: Optional[int] = None,
                               eff_rank_o: Optional[int] = None):
    """x: (B, K) one token per slot, K equal to the packed QKV operand's;
    mqkv: merged QKV group (qv (3, K//32, R), qu_t (3, R//32, Nmax),
    s1 (3, Nmax), s2 (3, K), rmask (3, R)); wo: packed output projection
    (qv (Ko//32, Ro), qu_t (Ro//32, No), s1 (No,), s2 (Ko,)); dims:
    (Hq*D, Hkv*D). Returns (y (B, No), k_new (B, Hkv, D), v_new
    (B, Hkv, D)). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    B, K = x.shape
    nq, nkv = dims
    hkv = nkv // head_dim
    NP, PS, Hkv_p, D_p = k_pool.shape
    if (Hkv_p, D_p) != (hkv, head_dim) or nq % nkv:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match dims "
                         f"{tuple(dims)} / head_dim {head_dim}")
    qv3, qu3 = mqkv["qv"], mqkv["qu_t"]
    R, Nmax = qv3.shape[-1], qu3.shape[-1]
    if qv3.shape != (3, K // 32, R) or K % 32 or qu3.shape != (3, R // 32, Nmax) \
            or Nmax < nq or Nmax < nkv:
        raise ValueError(f"merged QKV {tuple(qv3.shape)} / {tuple(qu3.shape)} "
                         f"does not match x {tuple(x.shape)}")
    Ko, Ro = wo["qv"].shape[0] * 32, wo["qv"].shape[1]
    No = wo["qu_t"].shape[1]
    if Ko < nq or wo["qu_t"].shape[0] * 32 != Ro:
        raise ValueError(f"wo {tuple(wo['qv'].shape)} / "
                         f"{tuple(wo['qu_t'].shape)} does not match dims")
    r_eff = R if eff_rank is None else int(eff_rank)
    ro_eff = Ro if eff_rank_o is None else int(eff_rank_o)
    if not (0 < r_eff <= R and r_eff % 32 == 0
            and 0 < ro_eff <= Ro and ro_eff % 32 == 0):
        raise ValueError(f"eff_rank {eff_rank} / eff_rank_o {eff_rank_o} "
                         f"must be multiples of 32 within ({R}, {Ro})")
    if x.device.type == "cpu":
        return ref.decode_step_ref(
            x, mqkv, wo, k_pool, v_pool, block_table, q_pos, cache_pos,
            head_dim=head_dim, dims=dims, theta=theta, scale=scale,
            window=window, eff_rank=eff_rank, eff_rank_o=eff_rank_o)
    name = "decode_step_megakernel_raw"
    rmask = mqkv.get("rmask")
    if rmask is None:
        rmask = torch.ones((3, R), dtype=torch.float32, device=x.device)
    build.check_cuda(name, x.dtype, x=x, k_pool=k_pool, v_pool=v_pool)
    build.check_cuda(name, torch.int32, qv3=qv3, qu3=qu3, qvo=wo["qv"],
                     quo=wo["qu_t"], block_table=block_table, q_pos=q_pos,
                     cache_pos=cache_pos)
    build.check_cuda(name, torch.float32, s1_3=mqkv["s1"], s2_3=mqkv["s2"],
                     rmask=rmask, s1o=wo["s1"], s2o=wo["s2"])
    build.check_cuda(name, x=x, qv3=qv3, s1o=wo["s1"])
    if tuple(block_table.shape[:1]) != (B,) or tuple(q_pos.shape) != (B,) \
            or tuple(cache_pos.shape) != (B,):
        raise ValueError("block_table / positions do not match the batch")
    code = build.dtype_code(x)
    y = torch.empty((B, No), dtype=x.dtype, device=x.device)
    k_new = torch.empty((B, hkv, head_dim), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    fn = build.library("megakernel").nq_decode_megakernel
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 16
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(build.ptr(x), build.ptr(qv3), build.ptr(qu3),
             build.ptr(mqkv["s2"]), build.ptr(mqkv["s1"]), build.ptr(rmask),
             build.ptr(wo["qv"]), build.ptr(wo["qu_t"]), build.ptr(wo["s2"]),
             build.ptr(wo["s1"]), build.ptr(k_pool), build.ptr(v_pool),
             build.ptr(block_table), build.ptr(q_pos), build.ptr(cache_pos),
             build.ptr(y), build.ptr(k_new), build.ptr(v_new),
             B, K, R, r_eff, Nmax, Ko, Ro, ro_eff, No, nq, nkv, head_dim,
             hkv, block_table.shape[1], PS, int(window), float(scale),
             float(theta), code, build.current_stream(x.device))
    build.check_launch(name, err)
    decode_step_megakernel_raw.launches += 1
    return y, k_new, v_new


decode_step_megakernel_raw.launches = 0
