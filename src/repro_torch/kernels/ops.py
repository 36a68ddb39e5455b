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

A policy can be passed explicitly, installed for a scope (``with
kernel_policy(p): ...``, contextvar-based) or installed process-wide
(:func:`set_kernel_policy`). The launch planners size each grid from the
occupancy query; there is no counterpart of the TPU tile table.

Tensor parallelism (the reference's shard_map launches, made explicit):
a policy carrying a ``mesh`` (``repro_torch.launch.mesh.Mesh``) runs each
launch on this rank's shard, placed by ``quant.surgery.place_on_mesh``
under the Megatron pairing of ``sharding.rules``. A column-parallel linear
(``tp="col"``) launches on its d_out shard with no collective; a
row-parallel one (``tp="row"``) launches on its d_in shard, which gives a
full-width partial sum, and ONE all-reduce finishes it
(``sharding.comm.all_reduce_sum``). Merged groups are column-local, an
expert stack's launch runs the rank's own experts (G = E / N), the paged
attention reads the local heads, and the megakernel declines under TP,
as the reference's does.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import binary_matmul, megakernel, ref
from repro_torch.kernels.build import KernelError
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
    mesh: Any = None

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

    def tp_size(self) -> int:
        """Ranks on the mesh's ``model`` axis (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.tp


_DEFAULT_POLICY = [KernelPolicy()]
_POLICY: contextvars.ContextVar[Optional[KernelPolicy]] = \
    contextvars.ContextVar("nanoquant_torch_kernel_policy", default=None)


def current_kernel_policy() -> KernelPolicy:
    scoped = _POLICY.get()
    return scoped if scoped is not None else _DEFAULT_POLICY[0]


def set_kernel_policy(policy: Union[KernelPolicy, str]) -> KernelPolicy:
    """Install `policy` process-wide (all threads); returns the previous
    default. Scoped :func:`kernel_policy` overrides still win."""
    prev = _DEFAULT_POLICY[0]
    _DEFAULT_POLICY[0] = KernelPolicy(mode=policy) \
        if isinstance(policy, str) else policy
    return prev


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
        raise KernelError(f"packed K {kw} is narrower than x's {d}")
    return F.pad(x, (0, kw - d))


def _slice_rank(qv, qu_t, eff_rank: int):
    """Keep the leading ``eff_rank`` rank columns of packed V and the
    leading ``eff_rank // 32`` packed rows of Uᵀ (views, no repack)."""
    r = qv.shape[-1]
    if not (0 < eff_rank <= r and eff_rank % 32 == 0):
        raise KernelError(f"eff_rank must be a multiple of 32 in (0, {r}], "
                          f"got {eff_rank}")
    return qv[..., :eff_rank], qu_t[..., :eff_rank // 32, :]


def _fits_fused(p: KernelPolicy, r: int) -> bool:
    return p.fused and r <= binary_matmul.MAX_FUSED_RANK


def _lowrank_forward(x, qv, qu_t, s1, s2, p: KernelPolicy,
                     eff_rank: Optional[int]):
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


class _LowrankBinaryMatmul(torch.autograd.Function):
    """The packed linear, or a stack of experts' (``expert``: x (E, C, K),
    words and scales with a leading E), with a gradient for x, s1 and s2
    (the packed words get none). Forward: the dispatch of
    :func:`lowrank_binary_matmul` or :func:`lowrank_binary_matmul_expert`,
    whatever the grad mode. Backward: plain f32 ops over the unpacked ±1
    factors, each expert's alone — with t = (x ⊙ s2) @ V and g the output
    gradient, ∂s1 = Σ_rows g ⊙ (t @ Uᵀ), ∂(x ⊙ s2) = ((g ⊙ s1) @ U) @ Vᵀ,
    then ∂x and ∂s2 by the product rule — the JAX package's autodiff of
    its packed ``dense`` / ``dense_expert`` path, without its roundings to
    x's dtype."""

    @staticmethod
    def forward(ctx, x, qv, qu_t, s1, s2, policy, eff_rank, expert):
        ctx.save_for_backward(x, qv, qu_t, s1, s2)
        ctx.eff_rank, ctx.expert = eff_rank, expert
        fwd = _expert_forward if expert else _lowrank_forward
        return fwd(x, qv, qu_t, s1, s2, policy, eff_rank)

    @staticmethod
    def backward(ctx, g):
        x, qv, qu_t, s1, s2 = ctx.saved_tensors
        if ctx.eff_rank is not None:
            qv, qu_t = _slice_rank(qv, qu_t, ctx.eff_rank)
        v = ref.unpack_signs(qv)                        # ([E,] K, r)
        u_t = ref.unpack_signs(qu_t)                    # ([E,] r, N)
        if ctx.expert:                                  # rows: axis 1
            gf, xf = g.float(), x.float()
            s1f, s2f = s1.float()[:, None], s2.float()[:, None]
        else:                                           # rows: all leading
            gf = g.float().reshape(-1, g.shape[-1])
            xf = x.float().reshape(-1, x.shape[-1])
            s1f, s2f = s1.float(), s2.float()
        need_x, need_s1, need_s2 = (ctx.needs_input_grad[i]
                                    for i in (0, 3, 4))
        grad_x = grad_s1 = grad_s2 = None
        if need_s1:
            t = (xf * s2f) @ v
            grad_s1 = (gf * (t @ u_t)).sum(-2).to(s1.dtype)
        if need_x or need_s2:
            gxs = ((gf * s1f) @ u_t.mT) @ v.mT          # ∂(x ⊙ s2)
            if need_x:
                grad_x = (gxs * s2f).to(x.dtype).reshape(x.shape)
            if need_s2:
                grad_s2 = (gxs * xf).sum(-2).to(s2.dtype)
        return grad_x, None, None, grad_s1, grad_s2, None, None, None


def _wants_grad(x, s1, s2) -> bool:
    """Whether a packed linear's call takes a gradient: with none to take
    the forward runs without the Function's per-call bookkeeping, which
    serving would pay per linear and step."""
    return torch.is_grad_enabled() and (x.requires_grad or s1.requires_grad
                                        or s2.requires_grad)


def finish_row_parallel(y, policy: Optional[KernelPolicy] = None):
    """The all-reduce that finishes a row-parallel linear's partial sums
    (identity without a tensor-parallel mesh)."""
    p = policy if policy is not None else current_kernel_policy()
    if p.tp_size() == 1:
        return y
    from repro_torch.sharding import comm
    return comm.all_reduce_sum(y, p.mesh)


def lowrank_binary_matmul(x, qv, qu_t, s1, s2,
                          policy: Optional[KernelPolicy] = None,
                          tp: Optional[str] = None,
                          eff_rank: Optional[int] = None):
    """y = s1 ⊙ ((x ⊙ s2) @ V±1) @ U±1ᵀ — packed operands (paper Eq. 1).
    The kernel path runs the fused kernel (f32 intermediate) up to
    MAX_FUSED_RANK with ``fused``, else the two-call chain (intermediate
    rounded to x's dtype, as the JAX package's two-call); the ref path
    the two-stage oracle (rounded likewise). Differentiable in x, s1 and
    s2 (:class:`_LowrankBinaryMatmul`), which the quantization pipeline's
    scale-only distillation needs. With no gradient to take (grad mode
    off, or none of x, s1, s2 requiring one) the same forward runs without
    the Function.

    `tp`: this linear's Megatron role (``sharding.rules.tp_role``),
    consulted only under a policy with a tensor-parallel mesh, where the
    operands are this rank's shard: "col" launches on the d_out shard with
    no collective; "row" launches on the d_in shard (x the matching slice
    of the activation) and one all-reduce sums the partials. Every rank's
    operands are whole rank columns, so ``eff_rank`` composes with both
    roles. A linear that ``place_on_mesh`` left whole (a shape that does
    not divide the axis) is passed with ``tp=None``: the replicated
    launch."""
    p = policy if policy is not None else current_kernel_policy()
    x = _match_packed_k(x, qv)
    if _wants_grad(x, s1, s2):
        y = _LowrankBinaryMatmul.apply(x, qv, qu_t, s1, s2, p, eff_rank,
                                       False)
    else:
        y = _lowrank_forward(x, qv, qu_t, s1, s2, p, eff_rank)
    return finish_row_parallel(y, p) if tp == "row" else y


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
    matches JAX's within the kernel tolerances.

    Merged groups are all column-parallel (QKV / gate-up). Under a
    tensor-parallel mesh each rank's group is merged from its own d_out
    shards (``quant.surgery.merge_projection_groups`` after
    ``place_on_mesh``), so the launch is shard-local with no collective
    and `dims` are the local widths."""
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


def _expert_forward(x, qv, qu_t, s1, s2, p: KernelPolicy,
                    eff_rank: Optional[int]):
    if p.use_kernels(x.device) and _fits_fused(p, qv.shape[-1]):
        return binary_matmul.fused_lowrank_matmul_grouped(
            x.contiguous(), qv, qu_t, s1.float(), s2.float(),
            x_shared=False, eff_rank=eff_rank)
    if eff_rank is not None:
        qv, qu_t = _slice_rank(qv, qu_t, eff_rank)
    if p.use_kernels(x.device):
        return torch.stack([binary_matmul.lowrank_binary_matmul_twocall(
            x[e].contiguous(), qv[e], qu_t[e], s1[e].float(), s2[e].float())
            for e in range(qv.shape[0])])
    # the two-stage oracle of every expert at once (batched matmuls)
    return ref.lowrank_binary_matmul_ref(x, qv, qu_t, s1[:, None],
                                         s2[:, None])


def lowrank_binary_matmul_expert(x, qv, qu_t, s1, s2,
                                 policy: Optional[KernelPolicy] = None,
                                 eff_rank: Optional[int] = None):
    """Stacked-expert NanoQuant linear: x (E, C, d_in) with per-expert
    packed operands (E, ...) -> (E, C, d_out). On the kernel path the
    expert axis is the grid's group axis of the fused kernel: ONE launch
    for all E experts, x given per group, f32 rank intermediate. Past
    MAX_FUSED_RANK or with ``fused=False`` each expert runs the two-call
    chain (the JAX package vmaps ``lowrank_binary_matmul_twocall``). The
    ref path is the two-stage oracle for every expert, its intermediate
    rounded to x's dtype. eff_rank truncates every expert to the leading
    R' components (all experts share one packed rank). Differentiable in
    x, s1 and s2 through :class:`_LowrankBinaryMatmul`, taken only when a
    gradient is (as for :func:`lowrank_binary_matmul`).

    Expert-parallel under a tensor-parallel mesh: the operands are this
    rank's block of E / N whole experts (``place_on_mesh``) and `x` is
    already the matching local slice, the rows dispatched to those
    experts (``models.layers.moe`` buffers only them), so the launch is
    #1's grid at G = E / N with no collective, the reference's
    ``_shard_launch`` over the expert axis. The layer's one all-reduce
    comes after its combine; a replicated launch followed by it would
    count every expert N times."""
    p = policy if policy is not None else current_kernel_policy()
    if x.shape[0] != qv.shape[0]:
        raise KernelError(f"x holds {x.shape[0]} experts' rows, the packed "
                          f"stack {qv.shape[0]} experts")
    x = _match_packed_k(x, qv)
    if _wants_grad(x, s1, s2):
        return _LowrankBinaryMatmul.apply(x, qv, qu_t, s1, s2, p, eff_rank,
                                          True)
    return _expert_forward(x, qv, qu_t, s1, s2, p, eff_rank)


def paged_attention(q, k_pool, v_pool, block_table, q_pos, cache_pos, *,
                    window: int = 0, scale: float = 1.0,
                    policy: Optional[KernelPolicy] = None):
    """Block-table decode attention over a paged KV pool.

    q: (B, S, Hq, D) — S == 1 for decode, S > 1 for a multi-token read
    whose S rows are already in the pool (S single-token launches at
    shifted positions; the per-query mask keeps later rows out).

    Under a tensor-parallel mesh the caller passes this rank's heads:
    its query heads and the pool's kv heads they read (kv-head-sharded
    per ``sharding.rules.cache_pspecs(paged=True)``, or the one replicated
    kv head its query heads share), and each rank attends over them with
    no collective."""
    p = policy if policy is not None else current_kernel_policy()
    if not p.use_kernels(q.device):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table, q_pos,
                                       cache_pos, window=window, scale=scale)
    bt = block_table.to(torch.int32).contiguous()
    qp = q_pos.to(torch.int32)
    cp = cache_pos.to(torch.int32)
    # a pool is contiguous; the one-kv-head view of a replicated pool
    # (``quant.surgery.kv_layout``) is copied out for the launch
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
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
    runs the unfused chain, which is online-softmax-equal. It declines
    under a tensor-parallel mesh too, as the reference's does: its wo is
    row-parallel there and needs the all-reduce between the head-local
    attention and the residual, which the one launch has no place for.
    x: (B, K) one decode token per slot; dims: (Hq*D, Hkv*D)."""
    p = policy if policy is not None else current_kernel_policy()
    if not p.use_megakernel(x.device) or p.tp_size() > 1:
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
