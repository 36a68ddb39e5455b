"""Parity of the port's kernel modules with the JAX reference.

Each plain version in ``repro_torch`` (``kernels/ref.py`` and the CPU path
of every kernel wrapper) is held against its ``repro.kernels.ref`` twin on
the same numpy inputs, with the reference harness's tolerances
(``test_kernel_diff._tol``: relative max-abs 1e-5 f32, 3e-2 bf16), and
against the Pallas kernel itself in interpret mode for a small case. The
CUDA kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, packed, pair, tol
import jax

from repro.kernels import ops as jops
from repro.kernels import ref as _jref
from repro.kernels.binary_matmul import \
    fused_lowrank_matmul_grouped as j_fused_grouped
from repro.kernels.megakernel import decode_step_megakernel_raw as j_mega
from repro.kernels.paged_attention import paged_decode_attention as j_paged
from repro_torch.kernels import binary_matmul, megakernel, ops, paged_attention
from repro_torch.kernels import ref


class jref:
    """The JAX oracles, jitted: one compile per call shape is far cheaper
    on the CPU than dispatching every jnp op eagerly."""
    pack_signs = jax.jit(_jref.pack_signs)
    unpack_signs = jax.jit(_jref.unpack_signs)
    lowrank_binary_matmul_ref = jax.jit(_jref.lowrank_binary_matmul_ref)
    lowrank_binary_matmul_fused_ref = jax.jit(
        _jref.lowrank_binary_matmul_fused_ref, static_argnames=("eff_rank",))
    paged_attention_ref = jax.jit(_jref.paged_attention_ref,
                                  static_argnames=("window", "scale"))
    decode_step_ref = jax.jit(
        _jref.decode_step_ref,
        static_argnames=("head_dim", "dims", "theta", "scale", "window",
                         "eff_rank", "eff_rank_o"))


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(32, 1), (64, 40), (256, 7)])
def test_pack_unpack_bit_identical(k, n):
    rng = np.random.default_rng(k + n)
    a = np.where(rng.standard_normal((k, n)) > 0, 1.0, -1.0).astype(np.float32)
    want = np.asarray(jref.pack_signs(jnp.asarray(a)))
    got = ref.pack_signs(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got)
    words = packed(rng, k, n)
    jw, tw = pair(words)
    np.testing.assert_array_equal(np.asarray(jref.unpack_signs(jw)),
                                  ref.unpack_signs(tw).numpy())


# ---------------------------------------------------------------------------
# low-rank binary matmul: two-stage oracle, fused oracle, grouped wrapper
# ---------------------------------------------------------------------------


def _linear(rng, m, k, n, r, dt):
    x = rng.standard_normal((m, k)).astype(np.float32)
    return (pair(x, dt), pair(packed(rng, k, r)), pair(packed(rng, r, n)),
            pair(rng.standard_normal(n).astype(np.float32)),
            pair(rng.standard_normal(k).astype(np.float32)))


@pytest.mark.parametrize("dt,m,k,n,r", [("f32", 1, 32, 8, 32),
                                        ("bf16", 5, 96, 40, 64),
                                        ("f32", 8, 160, 72, 96)])
def test_lowrank_two_stage_oracle(dt, m, k, n, r):
    ops_ = _linear(np.random.default_rng(m * k + n), m, k, n, r, dt)
    want = jref.lowrank_binary_matmul_ref(*[o[0] for o in ops_])
    got = ref.lowrank_binary_matmul_ref(*[o[1] for o in ops_])
    assert_close(want, got, tol(dt), "two-stage")


@pytest.mark.parametrize("dt,m,k,n,r,eff", [("f32", 1, 64, 24, 64, None),
                                             ("bf16", 7, 96, 40, 128, 64),
                                             ("f32", 3, 224, 56, 96, 32)])
def test_fused_oracle_rmask_eff_rank(dt, m, k, n, r, eff):
    rng = np.random.default_rng(r + k)
    x, qv, qu, s1, s2 = _linear(rng, m, k, n, r, dt)
    rm = pair((np.arange(r) < r - 32).astype(np.float32))
    want = jref.lowrank_binary_matmul_fused_ref(
        x[0], qv[0], qu[0], s1[0], s2[0], rm[0], eff_rank=eff)
    got = ref.lowrank_binary_matmul_fused_ref(
        x[1], qv[1], qu[1], s1[1], s2[1], rm[1], eff_rank=eff)
    assert_close(want, got, tol(dt), "fused oracle")


def _grouped(rng, g, m, k, n, r, dt, shared):
    gx = 1 if shared else g
    x = rng.standard_normal((gx, m, k)).astype(np.float32)
    ranks = [r - 32 * (i % 2) for i in range(g)]
    rmask = np.stack([(np.arange(r) < ri) for ri in ranks]).astype(np.float32)
    return (pair(x, dt),
            pair(rng.integers(0, 2 ** 32, (g, k // 32, r), dtype=np.uint32)),
            pair(rng.integers(0, 2 ** 32, (g, r // 32, n), dtype=np.uint32)),
            pair(rng.standard_normal((g, n)).astype(np.float32)),
            pair(rng.standard_normal((g, k)).astype(np.float32)),
            pair(rmask))


@pytest.mark.parametrize("dt,g,m,k,n,r,shared,eff", [
    ("f32", 3, 1, 64, 40, 64, True, None),
    ("bf16", 2, 9, 96, 24, 96, True, 64),
    ("f32", 4, 3, 32, 16, 32, False, None)])
def test_grouped_wrapper_cpu_matches_oracle(dt, g, m, k, n, r, shared, eff):
    """The wrapper's CPU path (its plain version) against the JAX fused
    oracle applied per group — merged groups with ragged rmask and
    stacked-expert groups with per-group x."""
    ops_ = _grouped(np.random.default_rng(g * m + n), g, m, k, n, r, dt,
                    shared)
    (x, qv, qu, s1, s2, rm) = ops_
    want = [jref.lowrank_binary_matmul_fused_ref(
        x[0][0 if shared else i], qv[0][i], qu[0][i], s1[0][i], s2[0][i],
        rm[0][i], eff_rank=eff) for i in range(g)]
    got = binary_matmul.fused_lowrank_matmul_grouped(
        x[1], qv[1], qu[1], s1[1], s2[1], rm[1], x_shared=shared,
        eff_rank=eff)
    assert got.dtype == x[1].dtype and got.shape == (g, m, n)
    assert_close(jnp.stack(want), got, tol(dt), "grouped")


def test_grouped_wrapper_matches_pallas_interpret():
    """One merged case against the Pallas kernel in interpret mode, as
    the JAX package's own tests run it."""
    x, qv, qu, s1, s2, rm = _grouped(np.random.default_rng(3), 3, 5, 64, 48,
                                     64, "f32", True)
    want = j_fused_grouped(x[0], qv[0], qu[0], s1[0], s2[0], rm[0],
                           x_shared=True, bm=8, bn=16, bk=32, interpret=True)
    got = binary_matmul.fused_lowrank_matmul_grouped(
        x[1], qv[1], qu[1], s1[1], s2[1], rm[1], x_shared=True)
    assert_close(want, got, tol("f32"), "grouped vs pallas")


def test_grouped_wrapper_rejects_bad_operands():
    x, qv, qu, s1, s2, rm = _grouped(np.random.default_rng(4), 2, 2, 64, 16,
                                     32, "f32", True)
    with pytest.raises(ValueError):
        binary_matmul.fused_lowrank_matmul_grouped(
            x[1], qv[1], qu[1], s1[1], s2[1], rm[1], x_shared=False)
    with pytest.raises(ValueError):
        binary_matmul.fused_lowrank_matmul_grouped(
            x[1], qv[1], qu[1], s1[1], s2[1], rm[1], x_shared=True,
            eff_rank=48)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _paged_case(rng, B, Hq, Hkv, D, PS, pages, dt, S=1, n_pages=None):
    """Ragged tables: slot b maps a random number of pages (the rest null),
    its position inside them; the last slot maps nothing (all-null)."""
    n_pages = n_pages or B * pages + 1
    kp = rng.standard_normal((n_pages, PS, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, pages), np.int32)
    qpos = np.zeros(B, np.int32)
    used = 0
    for b in range(B - 1):
        k = int(rng.integers(1, pages + 1))
        bt[b, :k] = perm[used:used + k]
        used += k
        qpos[b] = int(rng.integers(0, k * PS - S + 1))
    return (pair(q, dt), pair(kp, dt), pair(vp, dt), pair(bt), pair(qpos),
            pair(qpos.copy()))


@pytest.mark.parametrize("dt,B,Hq,Hkv,D,PS,pages,S,window", [
    ("f32", 3, 4, 2, 16, 8, 3, 1, 0), ("bf16", 4, 6, 3, 8, 4, 5, 1, 6),
    ("f32", 2, 2, 2, 16, 16, 2, 3, 0), ("bf16", 3, 8, 2, 8, 8, 4, 2, 0)])
def test_paged_attention_oracle(dt, B, Hq, Hkv, D, PS, pages, S, window):
    case = _paged_case(np.random.default_rng(B * PS + pages), B, Hq, Hkv, D,
                       PS, pages, dt, S=S)
    scale = 1.0 / math.sqrt(D)
    want = jref.paged_attention_ref(*[c[0] for c in case], window=window,
                                    scale=scale)
    got = ref.paged_attention_ref(*[c[1] for c in case], window=window,
                                  scale=scale)
    assert_close(want, got, tol(dt), "paged oracle")
    if S == 1:
        got_w = paged_attention.paged_decode_attention(
            *[c[1] for c in case], window=window, scale=scale)
        assert_close(want, got_w, tol(dt), "paged wrapper (cpu)")
    pol = ops.KernelPolicy(mode="cuda")
    got_ops = ops.paged_attention(*[c[1] for c in case], window=window,
                                  scale=scale, policy=pol)
    assert_close(want, got_ops, tol(dt), "ops S-loop (cpu)")


def test_paged_attention_matches_pallas_interpret():
    case = _paged_case(np.random.default_rng(11), 3, 4, 2, 16, 8, 3, "f32")
    want = j_paged(*[c[0] for c in case], scale=0.25, interpret=True)
    got = paged_attention.paged_decode_attention(*[c[1] for c in case],
                                                 scale=0.25)
    assert_close(want, got, tol("f32"), "paged vs pallas")


# ---------------------------------------------------------------------------
# decode-step megakernel
# ---------------------------------------------------------------------------


def _mega_case(rng, B, hq, hkv, D, K, ranks, PS, pages, dt, ko_pad=0):
    nq, nkv = hq * D, hkv * D
    R, nmax = max(ranks), max(nq, nkv)
    rmask = np.stack([(np.arange(R) < r) for r in ranks]).astype(np.float32)
    s1 = rng.standard_normal((3, nmax)).astype(np.float32)
    for i, n in enumerate((nq, nkv, nkv)):
        s1[i, n:] = 0.0
    mqkv = {"qv": rng.integers(0, 2 ** 32, (3, K // 32, R), dtype=np.uint32),
            "qu_t": rng.integers(0, 2 ** 32, (3, R // 32, nmax),
                                 dtype=np.uint32),
            "s1": s1 / np.sqrt(R),
            "s2": rng.standard_normal((3, K)).astype(np.float32) / np.sqrt(K),
            "rmask": rmask}
    ko = nq + ko_pad
    s2o = rng.standard_normal(ko).astype(np.float32) / np.sqrt(nq)
    s2o[nq:] = 0.0
    wo = {"qv": packed(rng, ko, 64), "qu_t": packed(rng, 64, K),
          "s1": rng.standard_normal(K).astype(np.float32) / 8.0, "s2": s2o}
    x = rng.standard_normal((B, K)).astype(np.float32)
    case = _paged_case(rng, B, hq, hkv, D, PS, pages, dt)
    q_pos = case[4]
    as_pair = {k: pair(v) for k, v in mqkv.items()}
    wo_pair = {k: pair(v) for k, v in wo.items()}
    return (pair(x, dt), as_pair, wo_pair, case[1], case[2], case[3], q_pos,
            case[5])


def _mega_args(case, side):
    x, mqkv, wo, kp, vp, bt, qp, cp = case
    return (x[side], {k: v[side] for k, v in mqkv.items()},
            {k: v[side] for k, v in wo.items()}, kp[side], vp[side],
            bt[side], qp[side], cp[side])


@pytest.mark.parametrize("dt,B,hq,hkv,D,K,ranks,PS,pages,ko_pad", [
    ("f32", 3, 4, 2, 16, 64, (64, 32, 32), 8, 3, 0),
    ("bf16", 2, 4, 1, 8, 32, (32, 32, 32), 4, 4, 32)])
def test_megakernel_oracle(dt, B, hq, hkv, D, K, ranks, PS, pages, ko_pad):
    case = _mega_case(np.random.default_rng(B + K), B, hq, hkv, D, K, ranks,
                      PS, pages, dt, ko_pad)
    kw = dict(head_dim=D, dims=(hq * D, hkv * D), theta=10000.0,
              scale=1.0 / math.sqrt(D))
    want = jref.decode_step_ref(*_mega_args(case, 0), **kw)
    got = megakernel.decode_step_megakernel_raw(*_mega_args(case, 1), **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        assert_close(a, b, tol(dt), f"megakernel {nm}")


def test_megakernel_matches_pallas_interpret():
    case = _mega_case(np.random.default_rng(5), 3, 4, 2, 16, 64,
                      (64, 32, 32), 8, 3, "f32")
    kw = dict(head_dim=16, dims=(64, 32), theta=10000.0, scale=0.25)
    want = j_mega(*_mega_args(case, 0), bk=32, bn=32, interpret=True, **kw)
    got = megakernel.decode_step_megakernel_raw(*_mega_args(case, 1), **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        assert_close(a, b, tol("f32"), f"megakernel vs pallas {nm}")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_ops_ref_mode_matches_jax_ref_mode():
    rng = np.random.default_rng(21)
    x, qv, qu, s1, s2 = _linear(rng, 4, 96, 40, 64, "bf16")
    xw = pair(rng.standard_normal((4, 80)).astype(np.float32), "bf16")
    with jops.kernel_policy("ref"):
        want = jax.jit(jops.lowrank_binary_matmul)(xw[0], qv[0], qu[0],
                                                   s1[0], s2[0])
    got = ops.lowrank_binary_matmul(xw[1], qv[1], qu[1], s1[1], s2[1],
                                    policy=ops.KernelPolicy(mode="ref"))
    assert_close(want, got, tol("bf16"), "ref dispatch (K zero-extended)")


def test_policy_modes_and_megakernel_gating():
    cpu = torch.device("cpu")
    assert not ops.KernelPolicy().use_kernels(cpu)
    assert ops.KernelPolicy(mode="cuda").use_megakernel(cpu)
    assert not ops.KernelPolicy(mode="cuda", merge_projections=False
                                ).use_megakernel(cpu)
    with pytest.raises(ValueError):
        ops.KernelPolicy(mode="pallas")
    case = _mega_case(np.random.default_rng(6), 2, 4, 2, 8, 32, (32, 32, 32),
                      4, 2, "f32")
    args = _mega_args(case, 1)
    kw = dict(head_dim=8, dims=(32, 16), theta=1e4, scale=0.3)
    assert ops.decode_step_megakernel(*args, policy=ops.KernelPolicy(),
                                      **kw) is None
    assert ops.decode_step_megakernel(*args, policy=ops.KernelPolicy(
        mode="cuda"), eff_rank=48, **kw) is None
    assert ops.decode_step_megakernel(*args, policy=ops.KernelPolicy(
        mode="cuda"), **kw) is not None
