"""Parity of the port's two-call route with the JAX reference: the
``packed_matmul`` wrapper (its plain version on the CPU), the two-call
low-rank chain, and the merged groups past ``MAX_FUSED_RANK``.

The same numpy operands go to both packages; tolerances are the reference
harness's (``test_kernel_diff._tol``: relative max-abs 1e-5 f32, 3e-2
bf16). The JAX side runs its Pallas kernels in interpret mode, as its own
tests do. The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, packed, pair, tol
from repro.kernels import binary_matmul as jbm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import binary_matmul, ops

TILES = dict(bm=8, bn=16, bk=32)        # small Pallas tiles: quick interpret


def _operands(rng, m, k, n, dt, with_sk=True, with_sn=True):
    x = pair(rng.standard_normal((m, k)).astype(np.float32), dt)
    w = pair(packed(rng, k, n))
    sk = pair(rng.standard_normal(k).astype(np.float32) / np.sqrt(k)) \
        if with_sk else (None, None)
    sn = pair(rng.standard_normal(n).astype(np.float32)) \
        if with_sn else (None, None)
    return x, w, sk, sn


@pytest.mark.parametrize("dt,m,k,n,with_sk,with_sn", [
    ("f32", 1, 64, 40, True, True), ("f32", 5, 96, 24, False, True),
    ("bf16", 9, 160, 72, True, False), ("bf16", 3, 32, 8, False, False)])
def test_packed_matmul_matches_pallas_interpret(dt, m, k, n, with_sk,
                                                with_sn):
    """M, N and K off the tile multiples, scales given and omitted."""
    x, w, sk, sn = _operands(np.random.default_rng(m * k + n), m, k, n, dt,
                             with_sk, with_sn)
    want = jbm.packed_matmul(x[0], w[0], sk[0], sn[0], interpret=True,
                             **TILES)
    got = binary_matmul.packed_matmul(x[1], w[1], sk[1], sn[1])
    assert got.dtype == x[1].dtype and got.shape == (m, n)
    assert_close(want, got, tol(dt), "packed_matmul vs pallas")


def test_packed_matmul_out_dtype_and_strided_words():
    """An f32 result from bf16 activations (the merged route's rank
    intermediate), and a column slice of a wider packed matrix read as
    it lies."""
    rng = np.random.default_rng(17)
    x, w, sk, sn = _operands(rng, 4, 128, 96, "bf16")
    want = jref.packed_matmul_ref(x[0].astype(jnp.float32), w[0][:, :64],
                                  sk[0], sn[0][:64])
    view = w[1][:, :64]
    assert not view.is_contiguous()
    got = binary_matmul.packed_matmul(x[1], view, sk[1], sn[1][:64],
                                      out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert_close(want, got, tol("bf16"), "f32 out of bf16 x, strided words")


def test_packed_matmul_rejects_bad_operands():
    rng = np.random.default_rng(2)
    x, w, sk, sn = _operands(rng, 2, 64, 16, "f32")
    with pytest.raises(ValueError):
        binary_matmul.packed_matmul(x[1][:, :32], w[1])
    with pytest.raises(ValueError):
        binary_matmul.packed_matmul(x[1], w[1], sn[1], sk[1])
    with pytest.raises(ValueError):
        binary_matmul.packed_matmul(x[1][None], w[1])


def _linear(rng, m, k, n, r, dt):
    x = rng.standard_normal((m, k)).astype(np.float32)
    return (pair(x, dt), pair(packed(rng, k, r)), pair(packed(rng, r, n)),
            pair(rng.standard_normal(n).astype(np.float32) / np.sqrt(r)),
            pair(rng.standard_normal(k).astype(np.float32) / np.sqrt(k)))


@pytest.mark.parametrize("dt,m,k,n,r,eff", [
    ("f32", 3, 96, 40, 64, None), ("bf16", 6, 64, 24, 96, 64),
    ("f32", 1, 160, 56, 128, 32)])
def test_twocall_matches_jax(dt, m, k, n, r, eff):
    """Both packages' two-call chains (the JAX one in interpret mode) and
    the JAX two-stage oracle, with an eff_rank view sliced in place."""
    x, qv, qu, s1, s2 = _linear(np.random.default_rng(r + k), m, k, n, r, dt)
    jv, ju = (qv[0], qu[0]) if eff is None else \
        jops._slice_rank(qv[0], qu[0], eff)
    want = jbm.lowrank_binary_matmul_twocall(x[0], jv, ju, s1[0], s2[0],
                                             interpret=True, **TILES)
    oracle = jref.lowrank_binary_matmul_ref(x[0], jv, ju, s1[0], s2[0])
    tv, tu = (qv[1], qu[1]) if eff is None else \
        ops._slice_rank(qv[1], qu[1], eff)
    got = binary_matmul.lowrank_binary_matmul_twocall(x[1], tv, tu, s1[1],
                                                      s2[1])
    assert_close(want, got, tol(dt), "twocall vs pallas twocall")
    assert_close(oracle, got, tol(dt), "twocall vs two-stage oracle")


@pytest.mark.parametrize("eff", [None, 32])
def test_unfused_dispatch_matches_jax_unfused_dispatch(eff):
    """``KernelPolicy(fused=False)`` in both packages: every packed linear
    through the two-call chain (JAX: Pallas interpret)."""
    x, qv, qu, s1, s2 = _linear(np.random.default_rng(40), 5, 96, 48, 64,
                                "f32")
    want = jops.lowrank_binary_matmul(
        x[0], qv[0], qu[0], s1[0], s2[0], eff_rank=eff,
        policy=jops.KernelPolicy(mode="pallas", fused=False, interpret=True))
    got = ops.lowrank_binary_matmul(
        x[1], qv[1], qu[1], s1[1], s2[1], eff_rank=eff,
        policy=ops.KernelPolicy(mode="cuda", fused=False))
    assert_close(want, got, tol("f32"), "fused=False dispatch")


def _merged(rng, ranks, K, nouts):
    """A merged group as ``merge_projection_groups`` lays it out: every
    projection padded to the widest rank and output (rmask, s1 = 0)."""
    R, nmax, G = max(ranks), max(nouts), len(ranks)
    s1 = rng.standard_normal((G, nmax)).astype(np.float32) / np.sqrt(R)
    for g, n in enumerate(nouts):
        s1[g, n:] = 0.0
    return {"qv": rng.integers(0, 2 ** 32, (G, K // 32, R), dtype=np.uint32),
            "qu_t": rng.integers(0, 2 ** 32, (G, R // 32, nmax),
                                 dtype=np.uint32),
            "s1": s1,
            "s2": rng.standard_normal((G, K)).astype(np.float32) / np.sqrt(K),
            "rmask": np.stack([np.arange(R) < r for r in ranks]
                              ).astype(np.float32)}


@pytest.fixture
def low_threshold(monkeypatch):
    """MAX_FUSED_RANK = 32 in both packages, so smoke-size ranks run the
    paths that full-size ranks past 4096 run."""
    monkeypatch.setattr(jbm, "MAX_FUSED_RANK", 32)
    monkeypatch.setattr(binary_matmul, "MAX_FUSED_RANK", 32)
    return 32


@pytest.mark.parametrize("dt,ranks,eff", [
    ("f32", (96, 64, 64), None), ("bf16", (128, 96, 32), None),
    ("f32", (128, 64, 96), 64)])
def test_merged_past_threshold_matches_jax_oracle(low_threshold, dt, ranks,
                                                  eff):
    """Past the threshold JAX serves a merged group with its plain fused
    oracle (``_local_merged``); the port runs two packed_matmul launches
    per group with an f32 intermediate and rmask as stage 2's s_k. Both
    zero the padded rank columns, so the outputs agree."""
    rng = np.random.default_rng(sum(ranks))
    K, nouts = 64, (80, 40, 40)
    mp = _merged(rng, ranks, K, nouts)
    x = pair(rng.standard_normal((2, 3, K)).astype(np.float32), dt)
    jmp = {k: jnp.asarray(v) for k, v in mp.items()}
    tmp = {k: pair(v)[1] for k, v in mp.items()}
    want = jops.lowrank_binary_matmul_merged(
        x[0], jmp, nouts, eff_rank=eff,
        policy=jops.KernelPolicy(mode="pallas", interpret=True))
    got = ops.lowrank_binary_matmul_merged(
        x[1], tmp, nouts, eff_rank=eff, policy=ops.KernelPolicy(mode="cuda"))
    for i, (a, b) in enumerate(zip(want, got)):
        assert b.shape == (2, 3, nouts[i]) and b.dtype == x[1].dtype
        assert_close(a, b, tol(dt), f"merged projection {i}")


def _spy(monkeypatch, name, calls):
    real = getattr(binary_matmul, name)

    def spy(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)
    monkeypatch.setattr(binary_matmul, name, spy)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_twocall_route_launches(low_threshold, monkeypatch, groups):
    """On the kernel path past the threshold: two packed_matmul calls per
    linear (2·G for a merged group) and never the fused kernel; at or
    under it, the fused kernel alone."""
    rng = np.random.default_rng(groups)
    pol = ops.KernelPolicy(mode="cuda")
    calls = {}
    _spy(monkeypatch, "packed_matmul", calls)
    _spy(monkeypatch, "fused_lowrank_matmul_grouped", calls)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    if groups == 1:
        _, qv, qu, s1, s2 = _linear(rng, 1, 64, 24, 64, "f32")
        ops.lowrank_binary_matmul(x, qv[1], qu[1], s1[1], s2[1], policy=pol)
    else:
        mp = {k: pair(v)[1] for k, v in
              _merged(rng, (64,) * groups, 64, (24,) * groups).items()}
        ops.lowrank_binary_matmul_merged(x, mp, (24,) * groups, policy=pol)
    assert calls == {"packed_matmul": 2 * groups}
    calls.clear()
    _, qv, qu, s1, s2 = _linear(rng, 1, 64, 24, 32, "f32")
    ops.lowrank_binary_matmul(x, qv[1], qu[1], s1[1], s2[1], policy=pol)
    assert calls == {"fused_lowrank_matmul_grouped": 1}


def test_unfused_policy_gating():
    cpu = torch.device("cpu")
    p = ops.KernelPolicy(mode="cuda", fused=False)
    assert p.use_kernels(cpu)
    assert not p.use_merged_projections(cpu) and not p.use_megakernel(cpu)
    assert ops.KernelPolicy(mode="cuda").use_merged_projections(cpu)
