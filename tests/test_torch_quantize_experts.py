"""The building blocks of the port's MoE quantization against the JAX
reference, on deepseek-v2-lite-16b's smoke config (MLA attention, one
leading dense block, MoE blocks of 8 experts top-2 plus one shared
expert) and qwen3-moe's (GQA with qk_norm, 8 experts top-2), in float32,
with the ``_FAST`` budget of ``tests/test_torch_quantize.py``; the whole
pipeline is ``tests/test_torch_quantize_moe.py``'s.

Covered, each against the JAX package on the same numpy inputs: qwen3-moe's
block order and calibration taps (the experts' per-expert (E, d) moments,
counted over the capacity rows); ``preconditioners_for`` with
``expert_shape``; the stacked LB-ADMM latents from JAX's draws (one
batched solve, expert e drawing ``split(key, E)[e]``) and their packed
words; ``dense_expert``'s STE forward and gradient; the expert autograd
Function's gradients against the plain path and ``jax.grad``; TuneFP and
STE of deepseek's dense block, of its MoE block and of qwen3-moe's MoE
block, on JAX's microbatches of 4 rows (an MoE's output depends on its
rows). Tolerances as in ``tests/test_torch_quantize.py``: 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, check_block_tune,
                           check_collect_stats, jax_draws, jkey,
                           one_torch_thread, t_np, tol)  # noqa: F401
from repro import api as japi
from repro.core import pipeline as JP
from repro.core import precond as jprecond
from repro.core import util as jutil
from repro.data import synthetic as jdata
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import admm as tadmm
from repro_torch.core import pipeline as TP
from repro_torch.core import precond as tprecond
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL

DEEPSEEK, QWEN3_MOE = "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"
QC = dict(target_bpw=1.0, admm_iters=8, t_pre=4, t_post=6, t_glob=4,
          rank_align=32, min_dim=8)
F32 = tol("f32")


def _jparams(arch):
    cj = dataclasses.replace(japi.get_smoke(arch), dtype="float32")
    ct = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    return cj, ct, JT.init_params(jax.random.PRNGKey(0), cj)


def _experts(rng, E, d_in, d_out, r):
    """Stacked latents, scales and an input of E experts (one zero
    latent per factor: sign(0) -> +1)."""
    p = {"lu": rng.standard_normal((E, d_out, r)),
         "lv": rng.standard_normal((E, d_in, r)),
         "s1": rng.uniform(0.1, 1, (E, d_out)),
         "s2": rng.uniform(0.1, 1, (E, d_in))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["lu"][0, 0, 0] = p["lv"][1, 2, 3] = 0.0
    return p


# ---------------------------------------------------------------------------
# blocks, taps and preconditioners
# ---------------------------------------------------------------------------


def test_qwen3_moe_blocks_and_taps_match_jax():
    """qwen3-moe's blocks and every tap of JAX's calibration in the port's:
    the experts' (E, d) moments within 1e-5 and their counts (capacity
    rows, padding included) equal."""
    cj, ct, jparams = _jparams(QWEN3_MOE)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcal = jdata.calib_batches(cj, n_samples=8, seq=32, batch=4)
    tcal = tdata.calib_batches(ct, n_samples=8, seq=32, batch=4)
    fields = ("stack", "idx", "tap_idx", "kind")
    assert [tuple(getattr(b, f) for f in fields) for b in TP.blocks_of(ct)] \
        == [tuple(getattr(b, f) for f in fields) for b in JP.blocks_of(cj)] \
        == [("layers", i, i, "attn") for i in range(2)]
    want = jprecond.collect_stats(JT.loss_fn, jparams, cj, jcal)
    _, got = check_collect_stats(want, ct, tparams, tcal)
    for key, slot in got.data.items():
        if key[1] in ("moe.w_gate", "moe.w_up", "moe.w_down"):
            assert tuple(slot["sq"].shape)[0] == ct.n_experts, key
            assert slot["cnt"] % 8 == 0, key          # capacity rows
    assert {k[1] for k in got.data} == {
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "moe.w_gate",
        "moe.w_up", "moe.w_down"}


def test_expert_preconditioners_match_jax():
    """``preconditioners_for(..., expert_shape=E)`` from (E, C, d) taps:
    one robust diagonal per expert, identity (E, d) without stats."""
    rng = np.random.default_rng(2)
    E, C = 4, 24
    jc, tc = jprecond.StatCollector(), tprecond.StatCollector()
    x = (rng.standard_normal((E, C, 64)) ** 3).astype(np.float32)
    g = rng.standard_normal((E, C, 96)).astype(np.float32)
    x[2] = 0.0                                     # an expert never routed
    for field, arr in (("in", x), ("out", g)):
        jc._accumulate(("layers", "moe.w_up", field), 1,
                       np.square(arr).sum(1), C)
        tc.accumulate("layers", "moe.w_up", field, 1, t_np(arr), True)
    for name in ("moe.w_up", "moe.w_down"):           # w_down: no stats
        for idx in (1, None):
            want = jprecond.preconditioners_for(jc, "layers", name, idx, 64,
                                                96, 0.2, expert_shape=E)
            got = tprecond.preconditioners_for(tc, "layers", name, idx, 64,
                                               96, 0.2, expert_shape=E)
            for a, b in zip(want, got):
                assert tuple(b.shape) == tuple(a.shape)
                assert_close(a, b, F32, f"{name}[{idx}]")


# ---------------------------------------------------------------------------
# stacked LB-ADMM and packing, the STE linear and the expert Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,d_in,d_out", [(4, 64, 96), (3, 96, 64)])
def test_stacked_lb_admm_matches_jax(E, d_in, d_out):
    """One batched solve of E experts from JAX's draws (split(key, E)[e]
    each): latents and scales within 1e-5 of JAX's ``vmap``, identical
    packed words, one rank for all."""
    rng = np.random.default_rng(E * d_in)
    w = (rng.standard_normal((E, d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)
    di = rng.uniform(0.5, 2, (E, d_in)).astype(np.float32)
    do = rng.uniform(0.5, 2, (E, d_out)).astype(np.float32)
    qj = JP.QuantConfig(admm_iters=8)
    jlat, jr = JP._init_latent({"w": jnp.asarray(w)}, jnp.asarray(di),
                               jnp.asarray(do), qj, jkey((0, 3, 5)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadmm, "_rand_range_init", jax_draws)
        tlat, tr = TP._init_latent({"w": t_np(w)}, t_np(di), t_np(do),
                                   TP.QuantConfig(admm_iters=8), (0, 3, 5))
    assert tr == jr
    for k in ("lu", "lv", "s1", "s2"):
        assert tuple(tlat[k].shape) == tuple(jlat[k].shape), k
        assert_close(jlat[k], tlat[k], F32, k)
    want, got = JP._pack_latent(jlat), TP._pack_latent(tlat)
    for k in ("qu_t", "qv"):
        np.testing.assert_array_equal(np.asarray(want[k]).view(np.int32),
                                      got[k].numpy(), err_msg=k)
    # the port's own draws: expert e's solve alone equals its row of the
    # batched one
    tlat = TP._init_latent({"w": t_np(w)}, t_np(di), t_np(do),
                           TP.QuantConfig(admm_iters=8), (0, 3, 5))[0]
    u, v = tadmm._rand_range_init((0, 3, 5), t_np(w).mT, tr)
    u1, v1 = tadmm._rand_range_init((0, 3, 5, E, 1), t_np(w[1]).T, tr)
    assert torch.equal(u[1], u1) and torch.equal(v[1], v1)
    assert torch.isfinite(tlat["lu"]).all()


def test_dense_expert_ste_matches_jax():
    """The latent route of ``dense_expert`` (every expert's STE linear at
    once): forward and the gradients of every latent, scale and x against
    ``jax.grad`` through JAX's ``vmap(_ste_matmul)``."""
    rng = np.random.default_rng(4)
    p = _experts(rng, 3, 64, 40, 32)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)

    def jloss(pp, xx):
        return jnp.sum(jnp.sin(JL.dense_expert(pp, xx)))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: t_np(v).requires_grad_() for k, v in p.items()}
    tx = t_np(x).requires_grad_()
    y = TL.dense_expert(tp, tx)
    assert_close(JL.dense_expert(jp, jnp.asarray(x)), y, F32, "forward")
    torch.sin(y).sum().backward()
    for k in p:
        assert_close(jg[0][k], tp[k].grad, F32, f"d{k}")
    assert_close(jg[1], tx.grad, F32, "dx")


@pytest.mark.parametrize("E,C,K,r,N,eff", [(4, 8, 64, 32, 48, None),
                                           (3, 16, 96, 64, 32, 32)])
def test_expert_function_grads_match_plain_and_jax(E, C, K, r, N, eff):
    """``ops.lowrank_binary_matmul_expert``'s gradients of x, s1 and s2
    (its autograd Function, batched over the experts) against autograd
    through the plain two-stage oracle and ``jax.grad`` through JAX's
    per-expert oracle; the Function only when a gradient is taken."""
    rng = np.random.default_rng(E + C + K)
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    qv = rng.integers(0, 2 ** 32, (E, K // 32, r), dtype=np.uint32)
    qu = rng.integers(0, 2 ** 32, (E, r // 32, N), dtype=np.uint32)
    s1 = rng.uniform(0.1, 1, (E, N)).astype(np.float32)
    s2 = rng.uniform(0.1, 1, (E, K)).astype(np.float32)
    gy = rng.standard_normal((E, C, N)).astype(np.float32)
    tqv, tqu = (t_np(a.view(np.int32)) for a in (qv, qu))
    leaves = [t_np(a).requires_grad_() for a in (x, s1, s2)]
    calls = []
    apply = ops._LowrankBinaryMatmul.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops._LowrankBinaryMatmul, "apply",
                   lambda *a: calls.append(a[-1]) or apply(*a))
        y = ops.lowrank_binary_matmul_expert(leaves[0], tqv, tqu, leaves[1],
                                             leaves[2], eff_rank=eff)
        with torch.no_grad():
            y0 = ops.lowrank_binary_matmul_expert(
                t_np(x), tqv, tqu, t_np(s1), t_np(s2), eff_rank=eff)
    assert calls == [True] and torch.equal(y.detach(), y0)     # expert
    got = torch.autograd.grad(y, leaves, t_np(gy))
    rv, ru = (tqv[..., :eff], tqu[:, :eff // 32]) if eff else (tqv, tqu)
    plain = [t_np(a).requires_grad_() for a in (x, s1, s2)]
    yp = ref.lowrank_binary_matmul_ref(plain[0], rv, ru, plain[1][:, None],
                                       plain[2][:, None])
    assert_close(yp, y, F32, "forward")
    want = torch.autograd.grad(yp, plain, t_np(gy))
    jv, ju = (qv[..., :eff], qu[:, :eff // 32]) if eff else (qv, qu)

    def jloss(xx, a, b):
        return jnp.sum(jax.vmap(jref.lowrank_binary_matmul_ref)(
            xx, jnp.asarray(jv), jnp.asarray(ju), a, b) * gy)
    jgot = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (x, s1, s2)))
    for nm, a, b, c in zip(("x", "s1", "s2"), want, got, jgot):
        assert b.shape == a.shape and b.dtype == a.dtype
        assert_close(a, b, F32, f"d{nm} vs the oracle")
        assert_close(c, b, F32, f"d{nm} vs jax.grad")


# ---------------------------------------------------------------------------
# tuning on one block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,stack,idx", [(DEEPSEEK, "dense_layers", 0),
                                            (DEEPSEEK, "layers", 1),
                                            (QWEN3_MOE, "layers", 0)])
def test_block_tune_fp_and_ste_match_jax(arch, stack, idx):
    cj, ct, jparams = _jparams(arch)
    check_block_tune(cj, ct, jutil.tree_index(jparams[stack], idx), "attn",
                     QC)
