"""Dispatch for the packed binary kernels, governed by an immutable
:class:`KernelPolicy` (the single-device paths of ``repro.kernels.ops``):

- ``mode="ref"``  — the plain oracles of :mod:`repro_torch.kernels.ref`,
  unmerged, with the JAX reference path's roundings.
- ``mode="cuda"`` — the kernel wrappers (fused, merged projections,
  megakernel; the two-call ``packed_matmul`` chain for ranks past
  ``binary_matmul.MAX_FUSED_RANK`` or with ``fused=False``). A wrapper
  launches its CUDA kernel for CUDA tensors and takes its plain version
  for CPU tensors, so on the CPU this mode runs the kernels' dispatch
  structure with their plain versions.
- ``mode="auto"`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.

A policy can be passed explicitly or installed for a scope
(``with kernel_policy(p): ...``, contextvar-based). Block sizes are fixed inside the kernels for
now; there is no counterpart of the TPU tile table yet.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import binary_matmul, megakernel, ref
from repro_torch.kernels import paged_attention as paged_kernel

_MODES = ("auto", "ref", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """mode: see the module docstring. fused: on the kernel path, run
    packed linears up to MAX_FUSED_RANK through the fused kernel (False:
    every packed linear through the two-call chain, unmerged).
    merge_projections: allow grouped QKV / gate-up launches on the
    kernel path (needs ``fused``). megakernel: try the fused decode-step
    kernel (per-launch gating still applies, see
    :func:`decode_step_megakernel`)."""
    mode: str = "auto"
    fused: bool = True
    merge_projections: bool = True
    megakernel: bool = True

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown kernel mode {self.mode!r}; choose from {_MODES}")

    def use_kernels(self, device) -> bool:
        """Whether operands on `device` go through the kernel wrappers."""
        if self.mode == "auto":
            return torch.device(device).type == "cuda"
        return self.mode == "cuda"

    def use_merged_projections(self, device) -> bool:
        return self.use_kernels(device) and self.fused \
            and self.merge_projections

    def use_megakernel(self, device) -> bool:
        return self.use_merged_projections(device) and self.megakernel


_POLICY: contextvars.ContextVar[KernelPolicy] = contextvars.ContextVar(
    "nanoquant_torch_kernel_policy", default=KernelPolicy())


def current_kernel_policy() -> KernelPolicy:
    return _POLICY.get()


@contextlib.contextmanager
def kernel_policy(policy: Union[KernelPolicy, str]):
    """Scoped policy override (this thread / task only)."""
    if isinstance(policy, str):
        policy = KernelPolicy(mode=policy)
    token = _POLICY.set(policy)
    try:
        yield current_kernel_policy()
    finally:
        _POLICY.reset(token)


def _match_packed_k(x, qv):
    """Zero-extend x's feature dim to the packed operand's K: stored
    operands may be K-aligned past the activation width, and the padded
    s2 columns are zero."""
    kw = qv.shape[-2] * 32
    d = x.shape[-1]
    if kw == d:
        return x
    if kw < d:
        raise ValueError(f"packed K {kw} is narrower than x's {d}")
    return F.pad(x, (0, kw - d))


def _slice_rank(qv, qu_t, eff_rank: int):
    """Keep the leading ``eff_rank`` rank columns of packed V and the
    leading ``eff_rank // 32`` packed rows of Uᵀ (views, no repack)."""
    r = qv.shape[-1]
    if not (0 < eff_rank <= r and eff_rank % 32 == 0):
        raise ValueError(f"eff_rank must be a multiple of 32 in (0, {r}], "
                         f"got {eff_rank}")
    return qv[..., :eff_rank], qu_t[..., :eff_rank // 32, :]


def _fits_fused(p: KernelPolicy, r: int) -> bool:
    return p.fused and r <= binary_matmul.MAX_FUSED_RANK


def lowrank_binary_matmul(x, qv, qu_t, s1, s2,
                          policy: Optional[KernelPolicy] = None,
                          eff_rank: Optional[int] = None):
    """y = s1 ⊙ ((x ⊙ s2) @ V±1) @ U±1ᵀ — packed operands (paper Eq. 1).
    The kernel path runs the fused kernel (f32 intermediate) up to
    MAX_FUSED_RANK with ``fused``, else the two-call chain (intermediate
    rounded to x's dtype, as the JAX package's two-call); the ref path
    the two-stage oracle (rounded likewise)."""
    p = policy if policy is not None else current_kernel_policy()
    x = _match_packed_k(x, qv)
    if p.use_kernels(x.device):
        if _fits_fused(p, qv.shape[-1]):
            return binary_matmul.fused_lowrank_matmul(
                x.contiguous(), qv, qu_t, s1.float(), s2.float(),
                eff_rank=eff_rank)
        if eff_rank is not None:
            qv, qu_t = _slice_rank(qv, qu_t, eff_rank)
        return binary_matmul.lowrank_binary_matmul_twocall(
            x.contiguous(), qv, qu_t, s1.float(), s2.float())
    if eff_rank is not None:
        qv, qu_t = _slice_rank(qv, qu_t, eff_rank)
    return ref.lowrank_binary_matmul_ref(x, qv, qu_t, s1, s2)


def lowrank_binary_matmul_merged(x, mp, dims: Sequence[int],
                                 policy: Optional[KernelPolicy] = None,
                                 eff_rank: Optional[int] = None
                                 ) -> List[torch.Tensor]:
    """Grouped projections sharing one input (QKV / gate-up): ONE kernel
    launch instead of len(dims). mp: merged group from
    ``quant.surgery.merge_projection_groups``; dims: true d_out per
    projection. Off the kernel path the fallback is the grouped fused
    oracle (f32 intermediate), as in the JAX package.

    Past MAX_FUSED_RANK (or with ``fused=False``) the kernel path departs
    from the JAX package on purpose: JAX runs its plain fused oracle
    there (``repro.kernels.ops._local_merged``), and a plain version has
    no place on the card's path. Each group instead runs two
    ``packed_matmul`` launches, ``t = (x ⊙ s2_g) @ V_g`` kept in f32 and
    ``y = ((t ⊙ rmask_g) @ U_g) ⊙ s1_g``: rmask as stage 2's s_k zeroes
    the padded rank columns (padded V words unpack to -1, so stage 1
    alone does not). That is the fused oracle's arithmetic, so the result
    matches JAX's within the kernel tolerances."""
    p = policy if policy is not None else current_kernel_policy()
    x = _match_packed_k(x, mp["qv"])
    shape = x.shape
    x2 = x.reshape(1, -1, shape[-1]).contiguous()
    R = mp["qv"].shape[-1]
    rmask = mp.get("rmask")
    if p.use_kernels(x.device) and _fits_fused(p, R):
        yg = binary_matmul.fused_lowrank_matmul_grouped(
            x2, mp["qv"], mp["qu_t"], mp["s1"], mp["s2"], rmask,
            x_shared=True, eff_rank=eff_rank)
    elif p.use_kernels(x.device):
        yg = _merged_twocall(x2[0], mp, rmask, eff_rank)
    else:
        yg = binary_matmul.fused_lowrank_matmul_grouped_ref(
            x2, mp["qv"], mp["qu_t"], mp["s1"], mp["s2"], rmask,
            x_shared=True, eff_rank=eff_rank)
    return [yg[i][:, :n].reshape(*shape[:-1], n) for i, n in enumerate(dims)]


def _merged_twocall(x, mp, rmask, eff_rank: Optional[int]):
    """A merged group through two packed_matmul launches per group with
    an f32 intermediate (see :func:`lowrank_binary_matmul_merged`).
    x: (M, K); returns one (M, Nmax) output per group."""
    qv, qu_t = mp["qv"], mp["qu_t"]
    if eff_rank is not None:
        qv, qu_t = _slice_rank(qv, qu_t, eff_rank)
    r = qv.shape[-1]
    ys = []
    for g in range(qv.shape[0]):
        t = binary_matmul.packed_matmul(x, qv[g], s_k=mp["s2"][g],
                                        out_dtype=torch.float32)
        ys.append(binary_matmul.packed_matmul(
            t, qu_t[g], s_k=None if rmask is None else rmask[g, :r],
            s_n=mp["s1"][g], out_dtype=x.dtype))
    return ys


def paged_attention(q, k_pool, v_pool, block_table, q_pos, cache_pos, *,
                    window: int = 0, scale: float = 1.0,
                    policy: Optional[KernelPolicy] = None):
    """Block-table decode attention over a paged KV pool.

    q: (B, S, Hq, D) — S == 1 for decode, S > 1 for a multi-token read
    whose S rows are already in the pool (S single-token launches at
    shifted positions; the per-query mask keeps later rows out)."""
    p = policy if policy is not None else current_kernel_policy()
    if not p.use_kernels(q.device):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table, q_pos,
                                       cache_pos, window=window, scale=scale)
    bt = block_table.to(torch.int32).contiguous()
    qp = q_pos.to(torch.int32)
    cp = cache_pos.to(torch.int32)
    outs = [paged_kernel.paged_decode_attention(
        q[:, j:j + 1].contiguous(), k_pool, v_pool, bt, qp + j, cp + j,
        window=window, scale=scale) for j in range(q.shape[1])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_step_megakernel(x, mqkv, wo, k_pool, v_pool, block_table, q_pos,
                           cache_pos, *, head_dim: int, dims: Sequence[int],
                           theta: float, scale: float, window: int = 0,
                           policy: Optional[KernelPolicy] = None,
                           eff_rank: Optional[int] = None,
                           eff_rank_o: Optional[int] = None):
    """Whole attention decode step in one launch (merged QKV → RoPE →
    paged attention with the fresh entry folded in → packed wo).

    Returns ``(y, k_new, v_new)`` or **None** when the launch does not
    qualify — off the kernel path, megakernel or merging off, ranks past
    MAX_FUSED_RANK, eff_rank not a multiple of 32 — and the caller then
    runs the unfused chain, which is online-softmax-equal.
    x: (B, K) one decode token per slot; dims: (Hq*D, Hkv*D)."""
    p = policy if policy is not None else current_kernel_policy()
    if not p.use_megakernel(x.device):
        return None
    if mqkv["qv"].dim() != 3 or wo["qv"].dim() != 2:
        return None
    if max(mqkv["qv"].shape[-1], wo["qv"].shape[-1]) \
            > binary_matmul.MAX_FUSED_RANK:
        return None
    for r_eff, qv in ((eff_rank, mqkv["qv"]), (eff_rank_o, wo["qv"])):
        if r_eff is not None and not (
                0 < r_eff <= qv.shape[-1] and r_eff % 32 == 0):
            return None
    x = _match_packed_k(x, mqkv["qv"]).contiguous()
    wo = dict(wo, s1=wo["s1"].float(), s2=wo["s2"].float())
    return megakernel.decode_step_megakernel_raw(
        x, mqkv, wo, k_pool, v_pool, block_table.to(torch.int32).contiguous(),
        q_pos.to(torch.int32), cache_pos.to(torch.int32),
        dims=tuple(dims), head_dim=head_dim, theta=theta, scale=scale,
        window=window, eff_rank=eff_rank, eff_rank_o=eff_rank_o)
