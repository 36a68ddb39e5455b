"""Paged gather decode attention: the CUDA kernel
``csrc/paged_attention.cu`` (replacing the TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention``), its wrapper
and its plain version (``ref.paged_attention_ref``).

Single-token GQA attention: each slot walks its block table over
``(n_pages, page_size, Hkv, D)`` K/V pools with an f32 online softmax;
virtual row r is valid when ``q_pos - ((cache_pos - r) mod rows) >= 0``
(and inside ``window`` when set), so unmapped entries pointing at the
null page 0 mask out.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref


def paged_decode_attention(q, k_pool, v_pool, block_table, q_pos, cache_pos,
                           *, window: int = 0, scale: float = 1.0):
    """q: (B, 1, Hq, D); k_pool / v_pool: (n_pages, page_size, Hkv, D);
    block_table: (B, pages) int32; q_pos / cache_pos: (B,) int32.
    Returns (B, 1, Hq, D) in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    B, S, Hq, D = q.shape
    NP, PS, Hkv, Dk = k_pool.shape
    if S != 1:
        raise ValueError("paged_decode_attention reads one token per slot")
    if Dk != D or Hq % Hkv or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(q_pos.shape) != (B,) or tuple(cache_pos.shape) != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"positions do not match batch {B}")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table, q_pos,
                                       cache_pos, window=window, scale=scale)
    name = "paged_decode_attention"
    build.check_cuda(name, q.dtype, q=q, k_pool=k_pool, v_pool=v_pool)
    build.check_cuda(name, torch.int32, block_table=block_table,
                     q_pos=q_pos, cache_pos=cache_pos)
    build.check_cuda(name, q=q, block_table=block_table)
    code = build.dtype_code(q)
    pages = block_table.shape[1]
    out = torch.empty_like(q)
    fn = build.library("paged_attention").nq_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
             build.ptr(block_table), build.ptr(q_pos), build.ptr(cache_pos),
             build.ptr(out), B, pages, PS, Hkv, Hq // Hkv, D, int(window),
             float(scale), code, build.current_stream(q.device))
    build.check_launch(name, err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
