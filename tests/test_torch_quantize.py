"""The port's quantization pipeline (dense family) against the JAX
reference, on the shape of ``tests/test_pipeline.py``'s tiny config (2
layers, d 64, 4 heads of 16, kv 2, d_ff 128, vocab 256) in float32, with
that file's ``_FAST`` budget (ADMM 8 iterations, TuneFP 4 steps, STE 6, KD
4, min_dim 32).

Covered, each against the JAX package on the same numpy inputs: SVID,
magnitude balancing, the robust diagonal and the preconditioners (with
the identity fallback), the ridge Cholesky solve, packing (identical
words), the calibration batches (identical arrays), AdamW + the cosine
schedule on a mixed bf16 / f32 tree, the calibration taps (every key, both
fields), LB-ADMM from JAX's range-finder start (residual trace, proxies,
health), one block's TuneFP and STE and the model's KD, the loss and the
STE linear; the packed linear's gradient against autograd through the
plain oracle and ``jax.grad`` through JAX's; the whole pipeline under
JAX's random draws (``core.admm._rand_range_init`` swapped for JAX's,
keyed by the same fold-in path) — report rows and packed sign bits; the
artifact read by JAX's ``NanoQuantModel.load`` (logits, engine tokens);
the paper's ordering against in-place binarization; the fallback ladder;
the refusals of what is still to come (a trained teacher: ROADMAP item
13) and of misused journal arguments; the CLI quantizing and serving.

Tolerances, each measured first and written beside its gate: 1e-5
relative max-abs (``_torch_common.tol("f32")``) where both packages do the
same f32 arithmetic. The whole-pipeline rows are looser: block 0's TuneFP
sees X_q == X_fp, where the port's loss is exactly 0 while JAX's jitted
forward differs from its eager target by ~1e-6, and AdamW turns that noise
into full-size steps; the weights then differ by ~1e-4 of their scale,
which STE sign flips near 0 amplify into a few percent of loss.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, bits, draw_prompts, jax_draws,
                           jax_engine, jkey, jpath,
                           one_torch_thread,  # noqa: F401
                           same_tokens, serve_engine, t_np, tol)
from repro import api as japi
from repro.core import admm as jadmm
from repro.core import balance as jbalance
from repro.core import baselines as jbaselines
from repro.core import packing as jpacking
from repro.core import pipeline as JP
from repro.core import precond as jprecond
from repro.core.svid import svid as jsvid
from repro.core.svid import svid_factors as jsvid_factors
from repro.core import util as jutil
from repro.core.bpw import bpw_report as jbpw_report
from repro.data import synthetic as jdata
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.quant.surgery import packed_model_bytes as jpacked_model_bytes
from repro.train import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.api import init_methods as tinit
from repro_torch.api.registry import Registry, UnknownNameError
from repro_torch.convert import params_from_numpy
from repro_torch.core import admm as tadmm
from repro_torch.core import balance as tbalance
from repro_torch.core import baselines as tbaselines
from repro_torch.core import packing as tpacking
from repro_torch.core import pipeline as TP
from repro_torch.core import precond as tprecond
from repro_torch.core import svid as tsvid
from repro_torch.core import util as tutil
from repro_torch.core.bpw import bpw_report
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.quant.surgery import packed_model_bytes
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.train import optim as toptim

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, loss_chunk=0,
            remat=False, dtype="float32")
_FAST = dict(admm_iters=8, t_pre=4, t_post=6, t_glob=4, rank_align=32,
             min_dim=32)
# the shorter budget of the reference's ladder tests
_SHORT = dict(admm_iters=4, t_pre=2, t_post=2, t_glob=2, rank_align=32,
              min_dim=32)
F32 = tol("f32")
# whole pipeline under JAX's draws (measured first: rows within 6 %,
# packed sign bits agreeing 83 % per leaf at the least, 89 % on average)
ROW_REL = 0.10
PRE_LOSS_ABS = 1e-4          # block 0's TuneFP loss: 0 here, ~7e-6 in JAX
SIGN_FLOOR, SIGN_MEAN_FLOOR = 0.75, 0.85
LINEARS = (("attn", ("wq", "wk", "wv", "wo")),
           ("ffn", ("w_gate", "w_up", "w_down")))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a, jnp.float32))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# fixtures: the tiny teacher and its calibration set in both packages, and
# one quantization of each (the JAX run is the file's one JAX pipeline)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cj, ct = JModelConfig(**TINY), ModelConfig(**TINY)
    jparams = JT.init_params(jax.random.PRNGKey(0), cj)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcal = jdata.calib_batches(cj, n_samples=8, seq=48, batch=4)
    tcal = tdata.calib_batches(ct, n_samples=8, seq=48, batch=4)
    return cj, ct, jparams, tparams, jcal, tcal


@pytest.fixture(scope="module")
def jax_run(tiny):
    cj, _, jparams, _, jcal, _ = tiny
    return JP.nanoquant_quantize(jparams, cj, jcal,
                                 JP.QuantConfig(target_bpw=1.0, **_FAST),
                                 verbose=False)


@pytest.fixture(scope="module")
def port_model(tiny):
    """The port's NanoQuantModel.quantize under JAX's draws."""
    _, ct, _, tparams, _, tcal = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadmm, "_rand_range_init", jax_draws)
        return NanoQuantModel.quantize(
            tparams, ct, tcal, TP.QuantConfig(target_bpw=1.0, **_FAST),
            verbose=False, device="cpu")


# ---------------------------------------------------------------------------
# the building blocks, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,iters", [(48, 64, 12), (128, 32, 8),
                                       (64, 64, 3)])
def test_svid_matches_jax(m, n, iters):
    p = np.random.default_rng(m + n).standard_normal((m, n)).astype(
        np.float32)
    p[0, :3] = 0.0                                   # sign(0) -> +1
    ja, jb = jsvid_factors(jnp.asarray(p), iters)
    ta, tb = tsvid.svid_factors(t_np(p), iters)
    assert_close(ja, ta, F32, "svid a")
    assert_close(jb, tb, F32, "svid b")
    assert_close(jsvid(jnp.asarray(p), iters),
                 tsvid.svid(t_np(p), iters), F32, "svid")
    assert_close(jbaselines.svid_rank1(jnp.asarray(p)),
                 tbaselines.svid_rank1(t_np(p)), F32, "svid_rank1")


def test_magnitude_balance_matches_jax():
    rng = np.random.default_rng(1)
    pu, pv = (rng.standard_normal(s).astype(np.float32)
              for s in ((96, 64), (48, 64)))
    do, di = (rng.uniform(0.5, 2.0, s).astype(np.float32) for s in (96, 48))
    want = jbalance.magnitude_balance(*(jnp.asarray(a)
                                        for a in (pu, pv, do, di)))
    got = tbalance.magnitude_balance(*(t_np(a) for a in (pu, pv, do, di)))
    for nm, a, b in zip(("lu", "lv", "s1", "s2"), want, got):
        assert_close(a, b, F32, nm)
    assert_close(jbalance.reconstruct(*want), tbalance.reconstruct(*got),
                 F32, "reconstruct")


def test_robust_diag_and_preconditioners_match_jax():
    rng = np.random.default_rng(2)
    ms = rng.gamma(0.5, 2.0, 80) ** 3
    ms[:4] = 0.0                                     # dead channels clip
    for gamma in (0.0, 0.2, 0.6):
        assert_close(jprecond.robust_diag(ms, gamma),
                     tprecond.robust_diag(ms, gamma), F32, f"gamma {gamma}")
    jc, tc = jprecond.StatCollector(), tprecond.StatCollector()
    x = rng.standard_normal((3, 5, 80)).astype(np.float32)
    g = rng.standard_normal((15, 48)).astype(np.float32)
    for col in (jc, tc):
        for field, arr in (("in", x), ("out", g)):
            sq = np.square(arr).sum(axis=tuple(range(arr.ndim - 1)))
            if col is jc:
                col._accumulate(("layers", "ffn.w_up", field), 3, sq,
                                arr.size // arr.shape[-1])
            else:
                col.accumulate("layers", "ffn.w_up", field, 3, t_np(arr))
    for name in ("ffn.w_up", "ffn.w_down"):            # w_down: no stats
        for idx in (3, None):
            want = jprecond.preconditioners_for(jc, "layers", name, idx,
                                                80, 48, 0.2)
            got = tprecond.preconditioners_for(tc, "layers", name, idx,
                                               80, 48, 0.2)
            for a, b in zip(want, got):
                assert b.dtype == torch.float32
                assert_close(a, b, F32, f"{name}[{idx}]")


@pytest.mark.parametrize("r,shift", [(16, 1e-3), (64, 0.5)])
def test_chol_solve_ridge_matches_jax(r, shift):
    rng = np.random.default_rng(r)
    a = rng.standard_normal((3 * r, r)).astype(np.float32)
    gram = a.T @ a
    rhs = rng.standard_normal((r, 40)).astype(np.float32)
    want = jadmm._chol_solve_ridge(jnp.asarray(gram), jnp.asarray(rhs),
                                   shift)
    got = tadmm._chol_solve_ridge(t_np(gram), t_np(rhs), torch.tensor(shift))
    assert_close(want, got, F32, "ridge solve")
    # not positive definite: NaN, as JAX's cholesky gives, for the guards
    bad = tadmm._chol_solve_ridge(t_np(-gram), t_np(rhs), torch.tensor(shift))
    assert torch.isnan(bad).all()


@pytest.mark.parametrize("d_in,k_align", [(64, 32), (96, 64), (80, 512)])
def test_pack_quantized_identical_words(d_in, k_align):
    rng = np.random.default_rng(d_in)
    lu = rng.standard_normal((48, 64)).astype(np.float32)
    lv = rng.standard_normal((d_in, 64)).astype(np.float32)
    lu[0, :5] = lv[1, :7] = 0.0                      # zero latents -> +1
    s1, s2 = rng.uniform(0.1, 1, 48), rng.uniform(0.1, 1, d_in)
    s1, s2 = s1.astype(np.float32), s2.astype(np.float32)
    want = jpacking.pack_quantized(*(jnp.asarray(a) for a in (lu, lv, s1,
                                                               s2)),
                                   k_align=k_align)
    got = tpacking.pack_quantized(*(t_np(a) for a in (lu, lv, s1, s2)),
                                  k_align=k_align)
    for k in ("qu_t", "qv"):
        np.testing.assert_array_equal(np.asarray(want[k]).view(np.int32),
                                      got[k].numpy(), err_msg=k)
    for k in ("s1", "s2"):                       # padded s2 entries are 0
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    assert tpacking.packed_nbytes(got) == jpacking.packed_nbytes(want)


def test_calib_batches_identical_arrays():
    """The batches hold JAX's arrays from the same seed: the tokens and
    labels, and the VLM's image embeddings (drawn after the tokens, in the
    config's bf16) bit for bit."""
    cfg = tconfigs.get_smoke("qwen1.5-0.5b")
    want = jdata.calib_batches(japi.get_smoke("qwen1.5-0.5b"), 12, 40,
                               batch=3, seed=5)
    got = tdata.calib_batches(cfg, 12, 40, batch=3, seed=5)
    assert len(want) == len(got) == 4
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    vlm = "llama-3.2-vision-90b"
    want = jdata.calib_batches(japi.get_smoke(vlm), 4, 8)
    got = tdata.calib_batches(tconfigs.get_smoke(vlm), 4, 8)
    assert sorted(got[0]) == ["image_embeds", "labels", "tokens"]
    assert got[0]["image_embeds"].dtype == torch.bfloat16
    for a, b in zip(want, got):
        np.testing.assert_array_equal(bits(a["image_embeds"]),
                                      bits(b["image_embeds"]))
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


def test_adamw_cosine_matches_jax_on_mixed_tree():
    """5 steps with clipping on a tree of f32 and bf16 leaves (and None
    placeholders): f32 leaves within 1e-5, bf16 leaves within one bf16
    ulp of JAX's; the learning rate is read before the step's increment."""
    rng = np.random.default_rng(3)
    shapes = {"a": {"w": (8, 5), "s1": (5,)}, "b": (7,)}
    params = {"a": {"w": rng.standard_normal((8, 5)).astype(np.float32),
                    "s1": rng.standard_normal(5).astype(np.float32)},
              "b": rng.standard_normal(7).astype(np.float32)}
    bf16 = {"a/w"}

    def tree(conv, dtypes):
        return {"a": {"w": conv(params["a"]["w"], dtypes[0]),
                      "s1": conv(params["a"]["s1"], dtypes[1])},
                "b": conv(params["b"], dtypes[1]), "c": None}

    jp = tree(lambda a, d: jnp.asarray(a).astype(d),
              (jnp.bfloat16, jnp.float32))
    tp = tree(lambda a, d: t_np(a).to(d), (torch.bfloat16, torch.float32))
    jopt = joptim.AdamW(joptim.cosine_schedule(1e-2, 5), clip_norm=1.0,
                        weight_decay=0.01)
    topt = toptim.AdamW(toptim.cosine_schedule(1e-2, 5), clip_norm=1.0,
                        weight_decay=0.01)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = {"a": {"w": rng.standard_normal((8, 5)) * 3,
                   "s1": rng.standard_normal(5)},
             "b": rng.standard_normal(7), "c": None}
        jg = jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype), g, jp)
        tg = tutil.tree_map(lambda a, p: t_np(a).to(p.dtype), g, tp)
        jp, js, jinfo = jopt.update(jg, js, jp)
        tp, ts, tinfo = topt.update(tg, ts, tp)
        assert ts.step == int(js.step) == step + 1
        assert_close(jinfo["lr"], tinfo["lr"], F32, "lr")
        assert_close(jinfo["grad_norm"], tinfo["grad_norm"], F32, "norm")
    for path, leaf in tutil.leaves_with_path(tp):
        want = jp
        for k in path.split("/"):
            want = want[k]
        if path in bf16:
            assert leaf.dtype == torch.bfloat16
            ulp = np.abs(_np(want)) * 2.0 ** -7
            assert np.all(np.abs(_np(want) - _np(leaf)) <= ulp + 1e-30), \
                path
        else:
            assert_close(want, leaf, F32, path)
    for moments in (ts.m, ts.v):
        assert all(m.dtype == torch.float32 for m in tutil.leaves(moments))
    assert toptim.constant_schedule(3e-4)(7).item() == pytest.approx(3e-4)
    warm = toptim.cosine_schedule(1.0, 10, warmup=4)
    jwarm = joptim.cosine_schedule(1.0, 10, warmup=4)
    for s in range(12):
        assert_close(jwarm(s), warm(s), F32, f"warmup step {s}")


def test_collect_stats_matches_jax(tiny):
    """Every tap key and both fields (sums and row counts) of the
    calibration pass; the port takes "in" and "out" in one forward and
    backward, JAX in two passes."""
    cj, ct, jparams, tparams, jcal, tcal = tiny
    want = jprecond.collect_stats(JT.loss_fn, jparams, cj, jcal)
    got = tprecond.collect_stats(TT.loss_fn, tparams, ct, tcal)
    assert sorted(want.data) == sorted(got.data)
    assert len(got.data) == 2 * 2 * 7
    for key, slot in want.data.items():
        assert got.data[key]["cnt"] == slot["cnt"] == 4 * 48 * 2, key
        assert_close(slot["sq"], got.data[key]["sq"].numpy(), F32, str(key))
    # the taps cost nothing outside collect_stats: no hook, no record
    x = torch.randn(2, 64, requires_grad=True)
    y = TL.dense({"w": torch.randn(64, 8)}, x, "attn.wq")
    assert y.grad_fn is not None and not y._backward_hooks


@pytest.mark.parametrize("m,n,r", [(96, 64, 32), (64, 128, 64),
                                   (48, 64, 64)])    # last: r > min(m, n)
def test_lb_admm_from_jax_start_matches_jax(m, n, r):
    """8 iterations from JAX's range-finder start (the port's draw swapped
    for JAX's): the residual trace, the factors and the proxies within
    1e-5 relative (measured at most 2.6e-6), the health identical."""
    rng = np.random.default_rng(m * n + r)
    w = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    cfg = jadmm.ADMMConfig(rank=r, iters=8)
    want = jadmm.lb_admm(jnp.asarray(w), cfg, jkey((0, 1, r)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadmm, "_rand_range_init", jax_draws)
        got = tadmm.lb_admm(t_np(w), tadmm.ADMMConfig(rank=r, iters=8),
                            (0, 1, r))
    assert_close(want["residual_trace"], got["residual_trace"], F32,
                 "residual trace")
    for k in ("p_u", "p_v", "u", "v", "z_u", "z_v"):
        assert_close(want[k], got[k], F32, k)
    for k in ("resets", "nonfinite", "diverged"):
        assert int(want["health"][k]) == int(got["health"][k]), k
    for k in ("rho_scale", "min_residual", "final_residual"):
        assert float(got["health"][k]) == pytest.approx(
            float(want["health"][k]), rel=F32), k


def test_lb_admm_guards_reject_nonfinite_steps():
    """A target with a NaN rejects every step: the factors keep their
    start, the penalty bump saturates, the solve is flagged."""
    w = torch.randn(32, 32)
    w[3, 4] = float("nan")
    cfg = tadmm.ADMMConfig(rank=32, iters=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadmm, "_rand_range_init",
                   lambda key, w, r: (torch.ones(32, r), torch.ones(32, r)))
        res = tadmm.lb_admm(w, cfg, (0,))
    h = res["health"]
    assert int(h["resets"]) == 6 and bool(h["diverged"])
    assert float(h["rho_scale"]) == cfg.rho_scale_max
    assert torch.isinf(res["residual_trace"]).all()
    assert torch.equal(res["u"], torch.ones(32, 32))


def test_range_init_is_keyed_by_path():
    w = torch.randn(40, 24)
    a = tadmm._rand_range_init((0, 1, 2), w, 32)      # over-complete
    b = tadmm._rand_range_init((0, 1, 2), w, 32)
    c = tadmm._rand_range_init((0, 1, 3), w, 32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (40, 32) and a[1].shape == (24, 32)


def test_loss_and_ste_linear_match_jax(tiny):
    cj, ct, jparams, tparams, jcal, tcal = tiny
    for chunk in (0, 16):
        c1 = dataclasses.replace(cj, loss_chunk=chunk)
        c2 = dataclasses.replace(ct, loss_chunk=chunk)
        b = dict(jcal[0], labels=jnp.asarray(jcal[0]["labels"]).at[0, :5]
                 .set(-1))                                   # masked labels
        tb = {k: t_np(np.asarray(v)).long() for k, v in b.items()}
        assert_close(JT.loss_fn(jparams, c1, b), TT.loss_fn(tparams, c2, tb),
                     F32, f"loss chunk {chunk}")
    rng = np.random.default_rng(4)
    p = {"lu": rng.standard_normal((24, 32)), "lv": rng.standard_normal(
        (40, 32)), "s1": rng.uniform(0.1, 1, 24), "s2": rng.uniform(
        0.1, 1, 40)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["lu"][0, 0] = 0.0
    x = rng.standard_normal((3, 40)).astype(np.float32)

    def jloss(pp, xx):
        return jnp.sum(jnp.sin(JL.dense(pp, xx)))
    jg = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v)
                                          for k, v in p.items()},
                                         jnp.asarray(x))
    tp = {k: t_np(v).requires_grad_() for k, v in p.items()}
    tx = t_np(x).requires_grad_()
    torch.sin(TL.dense(tp, tx)).sum().backward()
    for k in p:
        assert_close(jg[0][k], tp[k].grad, F32, f"d{k}")
    assert_close(jg[1], tx.grad, F32, "dx")
    assert torch.equal(TL.sign_ste(torch.tensor([0.0, -2.0, 3.0])),
                       torch.tensor([1.0, -1.0, 1.0]))


# ---------------------------------------------------------------------------
# the packed linear's gradient (kernel #1's autograd Function)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead,K,r,N,eff", [((5,), 64, 32, 48, None),
                                            ((2, 7), 96, 64, 40, None),
                                            ((3,), 64, 96, 32, 64)])
def test_packed_linear_grad_matches_oracle_and_jax(lead, K, r, N, eff):
    """grad_x / grad_s1 / grad_s2 of ``ops.lowrank_binary_matmul`` equal
    autograd through the plain two-stage oracle and ``jax.grad`` through
    ``repro.kernels.ref.lowrank_binary_matmul_ref`` (1e-5); the packed
    words take no gradient; the forward is the same with grad on or off."""
    rng = np.random.default_rng(K + r + N)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    qv = rng.integers(0, 2 ** 32, (K // 32, r), dtype=np.uint32)
    qu = rng.integers(0, 2 ** 32, (r // 32, N), dtype=np.uint32)
    s1 = rng.uniform(0.1, 1, N).astype(np.float32)
    s2 = rng.uniform(0.1, 1, K).astype(np.float32)
    gy = rng.standard_normal(lead + (N,)).astype(np.float32)
    tqv, tqu = (t_np(a.view(np.int32)) for a in (qv, qu))
    leaves = [t_np(a).requires_grad_() for a in (x, s1, s2)]
    y = ops.lowrank_binary_matmul(leaves[0], tqv, tqu, leaves[1], leaves[2],
                                  eff_rank=eff)
    got = torch.autograd.grad(y, leaves, t_np(gy))
    with torch.no_grad():
        y0 = ops.lowrank_binary_matmul(t_np(x), tqv, tqu, t_np(s1), t_np(s2),
                                       eff_rank=eff)
    assert torch.equal(y.detach(), y0)
    rv, ru = (tqv[:, :eff], tqu[:eff // 32]) if eff else (tqv, tqu)
    plain = [t_np(a).requires_grad_() for a in (x, s1, s2)]
    yp = ref.lowrank_binary_matmul_ref(plain[0], rv, ru, plain[1], plain[2])
    assert_close(yp, y, F32, "forward")
    want = torch.autograd.grad(yp, plain, t_np(gy))
    jv, ju = (qv[:, :eff], qu[:eff // 32]) if eff else (qv, qu)

    def jloss(xx, a, b):
        return jnp.sum(jref.lowrank_binary_matmul_ref(
            xx, jnp.asarray(jv), jnp.asarray(ju), a, b) * gy)
    jgot = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (x, s1, s2)))
    for nm, a, b, c in zip(("x", "s1", "s2"), want, got, jgot):
        assert b.shape == a.shape and b.dtype == a.dtype
        assert_close(a, b, F32, f"d{nm} vs the oracle")
        assert_close(c, b, F32, f"d{nm} vs jax.grad")


@pytest.mark.parametrize("grad_on,needs", [(False, True), (True, False),
                                           (True, True)])
def test_packed_linear_takes_function_only_for_a_gradient(monkeypatch,
                                                          grad_on, needs):
    """``ops.lowrank_binary_matmul`` goes through its autograd Function only
    when grad mode is on and x, s1 or s2 requires a gradient; otherwise it
    runs the same forward directly, with an identical result."""
    rng = np.random.default_rng(7)
    x = t_np(rng.standard_normal((6, 64)).astype(np.float32))
    qv = t_np(rng.integers(0, 2 ** 32, (2, 32), dtype=np.uint32)
            .view(np.int32))
    qu = t_np(rng.integers(0, 2 ** 32, (1, 40), dtype=np.uint32)
            .view(np.int32))
    s1 = t_np(rng.uniform(0.1, 1, 40).astype(np.float32))
    s2 = t_np(rng.uniform(0.1, 1, 64).astype(np.float32))
    want = ref.lowrank_binary_matmul_ref(x, qv, qu, s1, s2)
    calls = []
    apply = ops._LowrankBinaryMatmul.apply
    monkeypatch.setattr(ops._LowrankBinaryMatmul, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    with torch.set_grad_enabled(grad_on):
        y = ops.lowrank_binary_matmul(x, qv, qu, s1.requires_grad_(needs),
                                      s2)
    assert calls == ([1] if grad_on and needs else [])
    assert y.requires_grad == (grad_on and needs)
    assert torch.equal(y.detach(), want)


# ---------------------------------------------------------------------------
# tuning loops on one block, and KD, against JAX on the same inputs
# ---------------------------------------------------------------------------


def test_block_tune_fp_and_ste_match_jax(tiny):
    """TuneFP then STE on block 1 from the same inputs (X_q = 1.25 X_fp,
    the JAX init's latents): each loss within 1e-5 relative (measured at
    most 1.9e-6), the tuned leaves within 1e-5."""
    cj, ct, jparams, tparams, jcal, _ = tiny
    toks = jnp.concatenate([b["tokens"] for b in jcal])
    x0 = JT.embed_tokens(jparams, cj, toks)
    bp = jutil.tree_index(jparams["layers"], 1)
    japply, tapply = JP.make_apply(cj, "attn"), TP.make_apply(ct, "attn")
    Xq, Y = x0 * 1.25, japply(bp, x0, {})
    tX, tY = t_np(Xq), t_np(Y)
    to_t = lambda tree: params_from_numpy(jax.tree.map(np.asarray, tree),
                                          "cpu")
    jb, jl = JP._tune(japply, bp, lambda p: True, Xq, Y, {}, 4, 1e-4, 4,
                      True, None)
    tb, tl = TP._tune(tapply, to_t(bp), lambda p: True, tX, tY, {}, 4, 1e-4,
                      4, True, None)
    np.testing.assert_allclose(tl, jl, rtol=F32, err_msg="TuneFP losses")
    # the latents both STE runs start from: LB-ADMM of JAX's TuneFP output
    # (the port's init, held against JAX's by the LB-ADMM test above)
    lat = to_t(jb)
    qc = TP.QuantConfig(**_FAST)
    for li, path in enumerate(TP.linear_paths(lat, qc.min_dim)):
        p = TP._get_path(lat, path)
        d_in, d_out = p["w"].shape
        lp, _ = TP._init_latent(p, torch.ones(d_in), torch.ones(d_out), qc,
                                (0, li))
        lat = TP._set_path(lat, path, lp)
    jlat = tutil.tree_map(lambda t: jnp.asarray(_np(t)), lat)
    jb2, jl2 = JP._tune(japply, jlat, JP._is_latent_path, Xq, Y, {}, 6, 1e-5,
                        4, True, None)
    tb2, tl2 = TP._tune(tapply, lat, TP._is_latent_path, tX, tY, {}, 6,
                        1e-5, 4, True, None)
    np.testing.assert_allclose(tl2, jl2, rtol=F32, err_msg="STE losses")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jb2),
                            tutil.leaves(tb2)):
        assert_close(a, b, F32, jpath(path))


def test_kd_matches_jax(tiny, jax_run):
    """Phase 3 on JAX's packed model: the KD losses within 1e-5 relative
    and the tuned scales within 1e-5; only s1 / s2 change."""
    cj, ct, jparams, tparams, jcal, tcal = tiny
    jq, _ = jax_run
    qc = dict(_FAST, t_glob=3, lr_glob=1e-3)
    jout, jl = JP.tune_scales_kd(jparams, jq, cj, jcal,
                                 JP.QuantConfig(**qc))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    before = dict(tutil.leaves_with_path(tq))
    tout, tl = TP.tune_scales_kd(tparams, tq, ct, tcal, TP.QuantConfig(**qc))
    np.testing.assert_allclose(tl, jl, rtol=F32, err_msg="KD losses")
    flat_j = jax.tree_util.tree_leaves_with_path(jout)
    flat_t = tutil.leaves_with_path(tout)
    assert [jpath(k) for k, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (path, b) in zip(flat_j, flat_t):
        if path.rsplit("/", 1)[-1] in ("s1", "s2"):
            assert_close(a, b, F32, path)
        else:
            assert torch.equal(b, before[path]), path


# ---------------------------------------------------------------------------
# the whole pipeline under JAX's draws
# ---------------------------------------------------------------------------


def test_pipeline_rows_match_jax(jax_run, port_model):
    _, jrep = jax_run
    trep = port_model.report
    assert len(jrep["blocks"]) == len(trep["blocks"]) == 2
    assert trep["ranks"] == jrep["ranks"]
    for a, b in zip(jrep["blocks"], trep["blocks"]):
        assert b["block"] == a["block"] and b["fallbacks"] == a["fallbacks"]
        assert b["init_method"] == a["init_method"] == "lb_admm"
        if a["block"] == "layers[0]":
            assert abs(a["pre_loss"] - b["pre_loss"]) <= PRE_LOSS_ABS
        else:
            assert b["pre_loss"] == pytest.approx(a["pre_loss"],
                                                  rel=ROW_REL)
        for k in ("ste_loss", "block_err"):
            assert b[k] == pytest.approx(a[k], rel=ROW_REL), (a["block"], k)
    assert np.allclose(trep["kd_losses"], jrep["kd_losses"], rtol=ROW_REL)
    assert len(trep["seconds"]["blocks"]) == 2 and trep["wall_s"] > 0


def test_pipeline_sign_bits_agree_with_jax(jax_run, port_model):
    jq, _ = jax_run
    tq = port_model.params
    shares = []
    for grp, names in LINEARS:
        for nm in names:
            for leaf in ("qv", "qu_t"):
                a = np.asarray(jq["layers"][grp][nm][leaf]).view(np.int32)
                b = tq["layers"][grp][nm][leaf].numpy()
                assert a.shape == b.shape
                shares.append(1.0 - np.unpackbits(
                    (a ^ b).view(np.uint8)).mean())
    assert min(shares) >= SIGN_FLOOR and np.mean(shares) >= SIGN_MEAN_FLOOR


def test_port_artifact_loads_in_jax(port_model, tiny, tmp_path):
    """The port's artifact read by JAX's NanoQuantModel.load: the same
    leaves, JAX's f32 logits within 1e-5 of the port's, JAX's f32 engine
    tokens equal to the port's engine's."""
    cj, ct, _, _, jcal, _ = tiny
    d = str(tmp_path / "art")
    port_model.save(d)
    j = japi.NanoQuantModel.load(d)
    assert j.quantized and dataclasses.asdict(j.qcfg) == port_model.quant
    assert j.ranks == port_model.ranks
    toks = np.asarray(jcal[0]["tokens"])
    want = JT.forward(j.params, cj, toks)
    got = TT.forward(port_model.params, ct, t_np(toks).long())
    assert_close(want, got, F32, "logits")
    prompts = draw_prompts(ct, [5, 9, 3], seed=2)
    budgets = [6, 4, 7]
    jtoks, _, _ = jax_engine({}, j.cfg, j.params, prompts, budgets)
    back = NanoQuantModel.load(d, device="cpu")
    eng = InferenceEngine(back.params, back.cfg, ServeConfig(greedy=True),
                          max_batch=2, max_len=48, device="cpu")
    same_tokens(jtoks, serve_engine(eng, Request, prompts, budgets))


def test_quantized_beats_inplace_binarization(tiny, port_model):
    """Paper Table 2 ordering at tiny scale (the port of the reference's
    test): the quantized model's synthetic perplexity is below RTN's and
    XNOR's in-place binarization of every linear."""
    _, ct, _, tparams, _, _ = tiny
    evalb = tdata.calib_batches(ct, 8, 48, seed=123)
    ppl_q = port_model.perplexity(evalb)

    def binarize(node, fn):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], torch.Tensor):
                return dict(node, w=fn(node["w"]).to(node["w"].dtype))
            return {k: binarize(v, fn) for k, v in node.items()}
        return node
    for fn in (tbaselines.rtn_binarize, tbaselines.xnor_binarize):
        bin_params = dict(tparams, layers=binarize(tparams["layers"], fn))
        ppl_b = tdata.eval_perplexity(TT.loss_fn, bin_params, ct, evalb)
        assert ppl_q < ppl_b, (fn.__name__, ppl_q, ppl_b)
    for fn, jfn in ((tbaselines.rtn_binarize, jbaselines.rtn_binarize),
                    (tbaselines.xnor_binarize, jbaselines.xnor_binarize)):
        w = np.random.default_rng(5).standard_normal((64, 48)).astype(
            np.float32)
        assert_close(jfn(jnp.asarray(w)), fn(t_np(w)), F32, fn.__name__)


def test_quantized_structure_matches_template(port_model):
    from repro_torch.quant.surgery import LeafSpec, abstract_quantized_params
    tmpl = abstract_quantized_params(port_model.cfg, 1.0, min_dim=32)

    def same(t, p, path=""):
        if isinstance(t, LeafSpec):
            want = {"uint32": torch.int32}.get(t.dtype,
                                               getattr(torch, t.dtype))
            assert tuple(p.shape) == t.shape and p.dtype == want, path
            return
        assert sorted(t) == sorted(p), path
        for k in t:
            same(t[k], p[k], f"{path}/{k}")
    same(tmpl, port_model.params)
    assert port_model.size_report() == jpacked_model_bytes(
        JModelConfig(**TINY), 1.0, 32, 32, 32)


# ---------------------------------------------------------------------------
# the fallback ladder and the other init methods
# ---------------------------------------------------------------------------


@pytest.fixture
def nan_init():
    """An init method whose latents are NaN in block 0 (the key path's
    second entry) and LB-ADMM's elsewhere."""
    def init(w, d_in, d_out, *, rank, admm, key):
        lat = tinit.lb_admm_init(w, d_in, d_out, rank=rank, admm=admm,
                                 key=key)
        if key[1] == 0:
            lat = dict(lat, lu=torch.full_like(lat["lu"], float("nan")))
        return lat
    tinit.register_init_method("nan_init_test", init)
    yield "nan_init_test"
    tinit.INIT_METHODS.unregister("nan_init_test")


def test_nan_init_walks_fallback_ladder(tiny, nan_init):
    _, ct, _, tparams, _, tcal = tiny
    qcfg = TP.QuantConfig(target_bpw=1.0, init_method=nan_init,
                          **_SHORT)
    logs = []
    qp, rep = TP.nanoquant_quantize(tparams, ct, tcal, qcfg, verbose=False,
                                    heartbeat=logs.append)
    row = rep["blocks"][0]
    assert row["init_method"] == "dbf_admm"
    fb = row["fallbacks"][0]
    assert fb["method"] == nan_init and fb["layer"] == "attn.wk"
    assert fb["iteration"] is None and "non-finite latents" in fb["reason"]
    assert rep["blocks"][1]["fallbacks"] == []
    assert rep["blocks"][1]["init_method"] == nan_init
    assert logs[:2] == ["block=0/2 layers[0] start",
                        f"block=0/2 layers[0] done "
                        f"err={row['block_err']:.5f}"]
    assert logs[-1].startswith("kd step=2/2 loss=")
    logits = TT.forward(qp, ct, tcal[0]["tokens"])
    assert torch.isfinite(logits).all()


def test_fallback_ladder_exhaustion_is_structured(tiny, nan_init):
    _, ct, _, tparams, _, tcal = tiny
    qcfg = TP.QuantConfig(target_bpw=1.0, init_method=nan_init,
                          fallback_inits="", **_SHORT)
    with pytest.raises(TP.QuantizationError) as ei:
        TP.nanoquant_quantize(tparams, ct, tcal, qcfg, verbose=False)
    e = ei.value
    assert e.block == "layers[0]" and e.layer == "attn.wk"
    assert "exhausted" in e.reason and e.iteration is None
    assert str(e).startswith("quantization failed at block='layers[0]' "
                             "layer='attn.wk': init-method fallback ladder")
    want = jadmm.QuantizationError("attn.wk", "layers[0]", 3, "why")
    assert str(tadmm.QuantizationError("attn.wk", "layers[0]", 3,
                                       "why")) == str(want)


@pytest.mark.parametrize("method", ["dual_svid", "dbf_admm"])
def test_other_init_methods_run(tiny, method):
    _, ct, _, tparams, _, tcal = tiny
    qcfg = TP.QuantConfig(target_bpw=1.0, init_method=method,
                          **_SHORT)
    qp, rep = TP.nanoquant_quantize(tparams, ct, tcal, qcfg, verbose=False)
    assert [r["init_method"] for r in rep["blocks"]] == [method] * 2
    assert torch.isfinite(TT.forward(qp, ct, tcal[0]["tokens"])).all()


def test_dual_svid_and_dbf_inits_match_jax():
    """dual_svid's reconstruction (SVD signs aside) and dbf_admm from JAX's
    start, against JAX's within 1e-5 relative (measured at most 2e-6)."""
    w = np.random.default_rng(6).standard_normal((64, 48)).astype(
        np.float32)
    want = jbaselines.dual_svid_init(jnp.asarray(w), 32)
    got = tbaselines.dual_svid_init(t_np(w), 32)
    assert_close(jnp.asarray(want["lu"]) @ jnp.asarray(want["lv"]).T,
                 got["lu"] @ got["lv"].T, F32, "dual_svid")
    for k in ("s1", "s2"):
        assert_close(want[k], got[k], F32, f"dual_svid {k}")
    want = jbaselines.dbf_admm_init(jnp.asarray(w), 32, iters=6,
                                    key=jkey((0, 2)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadmm, "_rand_range_init", jax_draws)
        got = tbaselines.dbf_admm_init(t_np(w), 32, iters=6, key=(0, 2))
    for k in ("lu", "lv", "s1", "s2"):
        assert_close(want[k], got[k], F32, f"dbf_admm {k}")


def test_registry():
    reg = Registry("widget")
    reg.register("a", 1)

    @reg.register
    def b():
        pass
    assert reg.names() == ["a", "b"] and "b" in reg and len(reg) == 2
    with pytest.raises(UnknownNameError, match=r"unknown widget 'c'; "
                       r"available: \['a', 'b'\]"):
        reg.get("c")
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", 2)
    assert tinit.list_init_methods()[:3] == ["lb_admm", "dual_svid",
                                             "dbf_admm"]


# ---------------------------------------------------------------------------
# accounting, init laws, refusals, entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_size_accounting_matches_jax(arch):
    for full in (True, False):
        ct = (tconfigs.get_config if full else tconfigs.get_smoke)(arch)
        cj = (japi.get_config if full else japi.get_smoke)(arch)
        for bpw, k_align in ((1.0, 32), (0.55, 512)):
            assert packed_model_bytes(ct, bpw, 48, 32, k_align) == \
                jpacked_model_bytes(cj, bpw, 48, 32, k_align)
    shapes = [(2048, 512), (512, 2048), (8192, 2048)]
    assert bpw_report(shapes, target_bpw=0.8) == jbpw_report(
        shapes, target_bpw=0.8)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen1.5-0.5b",
                                  "qwen3-4b", "musicgen-medium",
                                  "qwen3-moe-235b-a22b",
                                  "deepseek-v2-lite-16b", "mamba2-370m",
                                  "zamba2-1.2b", "llama-3.2-vision-90b"])
def test_init_params_follows_jax_laws(arch):
    """The teacher's tree has JAX's structure, shapes and dtypes (qkv
    biases, qk_norm, audio's (K, V, d) tables and (d, K·V) head, the MoE's
    f32 router, stacked experts and shared experts, the leading dense
    blocks, MLA's projections, the Mamba2 mixer and the hybrid's unstacked
    shared block included, the VLM's two-axis self layers and its cross
    blocks with zero gates), and its draws JAX's laws."""
    ct = tconfigs.get_smoke(arch)
    want = JT.init_params(jax.random.PRNGKey(0), japi.get_smoke(arch))
    got = TT.init_params(ct, torch.Generator().manual_seed(0), "cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = tutil.leaves_with_path(got)
    assert [jpath(k) for k, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (path, b) in zip(flat_w, flat_g):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
        bf, leaf = b.float(), path.rsplit("/", 1)[-1]
        if leaf == "w":
            assert float(bf.std()) == pytest.approx(
                1 / np.sqrt(b.shape[-2]), rel=0.15), path
        elif path == "embed":
            assert float(bf.std()) == pytest.approx(0.02, rel=0.05)
        elif leaf in ("conv_x", "conv_B", "conv_C"):
            assert float(bf.std()) == pytest.approx(0.2, rel=0.15), path
        elif leaf == "dt_bias":
            lo, hi = np.log(1e-3), np.log(1e-1)
            assert lo <= float(bf.min()) < float(bf.max()) <= hi, path
        elif leaf == "A_log":                     # log linspace(1, 16)
            assert_close(a, b, F32, path)
        else:                                     # norms and D 1, biases 0
            assert torch.equal(bf, torch.full_like(bf, float(bf.flatten()[0])))
            assert float(bf.flatten()[0]) == float(np.asarray(a).flat[0])


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_blocks_of_matches_jax(arch):
    """The blocks in JAX's order, stacks, indices, tap indices and kinds
    (the MoE's leading dense blocks first, "mamba" for the SSM family, the
    hybrid's shared block first with an aggregate tap index; the VLM's
    self blocks at (group, i) before each group's cross block)."""
    ct = tconfigs.get_smoke(arch)
    fields = ("stack", "idx", "tap_idx", "kind")
    want = [tuple(getattr(b, f) for f in fields)
            for b in JP.blocks_of(japi.get_smoke(arch))]
    assert [tuple(getattr(b, f) for f in fields)
            for b in TP.blocks_of(ct)] == want
    for kind in {k for *_, k in want}:
        assert callable(TP.make_apply(ct, kind))


@pytest.mark.parametrize("kwarg", [
    {"journal_dir": "OTHER_RUN", "resume": True}, {"resume": True},
    {"faults": "CRASH_AT_0"}])
def test_unported_pipeline_kwargs_refuse(tiny, kwarg, tmp_path):
    """The journal and fault arguments, ported now, refuse their misuse
    at both entry points: a resume against another run's journal
    (``JournalError`` naming what differs), ``resume`` without a journal
    (``ValueError``); a planned crash fires (``InjectedPipelineCrash``)."""
    from repro_torch.checkpoint.journal import JournalError, QuantJournal
    from repro_torch.quant.faults import (InjectedPipelineCrash, QuantFault,
                                          QuantFaultPlan)
    _, ct, _, tparams, _, tcal = tiny
    qc = TP.QuantConfig(**_SHORT)
    if "journal_dir" in kwarg:
        QuantJournal(str(tmp_path)).start({"version": 1})
        kwarg, err = dict(kwarg, journal_dir=str(tmp_path)), \
            (JournalError, "different run")
    elif "faults" in kwarg:
        kwarg, err = {}, (InjectedPipelineCrash, "block 0")
    else:
        err = (ValueError, "journal_dir")
    for quantize in (TP.nanoquant_quantize,
                     lambda *a, **k: NanoQuantModel.quantize(
                         *a, device="cpu", **k)):
        if err[0] is InjectedPipelineCrash:
            kwarg = {"faults": QuantFaultPlan([QuantFault(0,
                                                          "crash_block")])}
        with pytest.raises(err[0], match=err[1]):
            quantize(tparams, ct, tcal, qc, verbose=False, **kwarg)


def test_quantize_entry_points_default_to_the_card(tiny):
    _, ct, _, tparams, _, tcal = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NanoQuantModel.quantize(tparams, ct, tcal)
    from repro_torch.launch import quantize as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--t-glob", "0"])


@pytest.mark.parametrize("flags,item", [
    (["--resume"], "--resume needs --journal-dir"),
    (["--supervise"], "--supervise needs --journal-dir"),
    (["--supervise", "--crash-at-block", "0"],
     "--supervise needs --journal-dir"),
    (["--init-method", "nope"], "unknown init method")])
def test_quantize_cli_refuses_unported_flags(flags, item, capsys):
    """The journal flags' misuse and an unknown init method, refused
    before any work: each exits non-zero with `item` in its message."""
    from repro_torch.launch import quantize as cli
    with pytest.raises(SystemExit) as ei:
        cli.main(flags + ["--device", "cpu"])
    assert ei.value.code != 0
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--teacher-steps", "--teacher-ckpt"])
def test_quantize_cli_accepts_teacher_flags(flag, tmp_path, capsys):
    """The teacher flags the port once refused: ``--teacher-steps 3``
    trains the teacher 3 steps, ``--teacher-ckpt DIR`` (with the default
    150 cut to 3) trains it into DIR and saves its last step; either run
    then quantizes it and reports both perplexities."""
    from repro_torch.launch import quantize as cli
    ckpt = str(tmp_path / "teacher")
    extra = ["--teacher-steps", "3"] + (
        ["--teacher-ckpt", ckpt] if flag == "--teacher-ckpt" else [])
    cli.main(extra + ["--device", "cpu", "--calib-samples", "4",
                      "--calib-seq", "32", "--admm-iters", "2", "--t-pre",
                      "1", "--t-post", "1", "--t-glob", "1"])
    text = capsys.readouterr().out
    for line in ("teacher at step 3: 3 steps trained", "FP teacher ppl",
                 "NanoQuant ppl"):
        assert line in text, line
    assert os.path.isdir(os.path.join(ckpt, "step_00000003")) == (
        flag == "--teacher-ckpt")


@pytest.mark.parametrize("arch", [None, "musicgen-medium",
                                  "qwen3-moe-235b-a22b", "mamba2-370m"])
def test_quantize_cli_then_serve(tmp_path, arch):
    """``launch.quantize --device cpu`` writes an artifact of the smoke
    config (llama3.2-1b's by default; one arch of each other family the
    port quantizes) that ``launch.serve --quantized-ckpt`` serves, and JAX
    loads."""
    out = str(tmp_path / "nq")
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    q = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quantize", "--device",
         "cpu", "--teacher-steps", "0", "--calib-samples", "4",
         "--calib-seq", "32", "--admm-iters",
         "4", "--t-pre", "2", "--t-post", "2", "--t-glob", "2", "--out",
         out] + (["--arch", arch] if arch else []),
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert q.returncode == 0, q.stderr
    for line in ("FP teacher ppl", "NanoQuant ppl", "linears bpw",
                 "wall time", f"saved to {out}"):
        assert line in q.stdout, line
    s = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--quantized-ckpt", out, "--requests", "2", "--prompt-len", "8",
         "--max-new", "4", "--max-batch", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert s.returncode == 0, s.stderr
    name = tconfigs.get_smoke(arch or "llama3.2-1b").name
    assert "loaded artifact" in s.stdout and f"arch={name}" in s.stdout
    j = japi.NanoQuantModel.load(out)
    assert j.quantized and j.cfg.name == name
