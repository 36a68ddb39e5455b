"""The port's trainer (``repro_torch.train``, ``launch.train`` and the
teacher flags of ``launch.quantize``) against the JAX package's.

The same params (JAX's ``init_params``, carried across by
``repro_torch.convert``) and the same batches (``make_batch``, numpy in
both packages) go through both packages' train steps in f32: the loss
within 1e-5 relative, the params after three AdamW steps within 1e-3
relative max-abs (tighter than the reference's own grad-accumulation
tolerance, rtol 3e-2 / atol 3e-3, ``tests/test_train.py``). Training
states checkpoint in JAX's layout and resume across the packages;
rematerialization changes no bit of the gradients on the CPU.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, f32, leaves_equal,  # noqa: F401
                           one_torch_thread, to_np, tol)
from repro import api as japi
from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint.journal import _crc_leaves as j_crc
from repro.data import SyntheticCorpus as JCorpus
from repro.data import make_batch as j_make_batch
from repro.data import train_iterator as j_train_iterator
from repro.train import Trainer as JTrainer
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train import grad_compress as JG
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.journal import _crc_leaves
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.core import precond as tprecond
from repro_torch.core import util
from repro_torch.data import SyntheticCorpus, make_batch, train_iterator
from repro_torch.launch.supervisor import run_with_restarts
from repro_torch.models import transformer as TT
from repro_torch.train import (TrainConfig, Trainer, init_train_state,
                               make_train_step)
from repro_torch.train import grad_compress as TG
from repro_torch.train.optim import AdamState

# one arch of each family (the MoE with MLA attention)
FAMILIES = {"dense": "llama3.2-1b", "moe": "deepseek-v2-lite-16b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b",
            "vlm": "llama-3.2-vision-90b", "audio": "musicgen-medium"}
TCFG = dict(lr=1e-3, warmup=2, total_steps=10)
STEP_TOL = 1e-3            # params after 3 steps, relative max-abs


def _cfg(arch):
    return f32(jconfigs.get_smoke(arch))


def _j_state(cfg, jt):
    """JAX's initial training state (PRNGKey(0)), its init jitted."""
    return jax.jit(lambda k: j_init_state(cfg, jt, key=k))(
        jax.random.PRNGKey(0))


def _t_batch(jb):
    """A JAX batch as the port's: ids int64, floats f32 (the VLM's image
    embeddings in the f32 configs)."""
    return {k: torch.from_numpy(np.array(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in jb.items()}


def _t_state(jstate):
    """JAX's (params, AdamState, eff) as the port's (CPU tensors)."""
    jp, jo, je = jstate
    conv = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return (conv(jp), AdamState(torch.from_numpy(np.array(jo.step)),
                                conv(jo.m), conv(jo.v)),
            torch.from_numpy(np.array(je)))


def _run_both(cfg, tcfg, n, jstate=None, batch=4, seq=16, split=None,
              with_jax=True):
    """`n` steps of JAX's jitted train step (none without `with_jax`) and
    the port's from the same state and batches: (JAX's state, the port's,
    both loss lists)."""
    jt = JTrainConfig(**tcfg)
    jstate = jstate or _j_state(cfg, jt)
    tstate = _t_state(jstate)
    jstep = jax.jit(j_make_step(cfg, jt)) if with_jax else None
    tstep = make_train_step(cfg, TrainConfig(**tcfg))
    corpus = JCorpus(cfg.vocab_size)
    jl, tl = [], []
    for s in range(n):
        jb = j_make_batch(cfg, corpus, 0, s, batch, seq)
        if split:
            jb = jax.tree.map(lambda x: x.reshape(split, -1, *x.shape[1:]),
                              jb)
        if with_jax:
            *jstate, jm = jstep(*jstate, jb)
            jl.append(float(jm["loss"]))
        *tstate, tm = tstep(*tstate, _t_batch(jb))
        tl.append(float(tm["loss"]))
    return tuple(jstate), tuple(tstate), jl, tl


def _params_close(jparams, tparams, tolerance, what):
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = util.leaves(tparams)
    assert len(flat) == len(got)
    for (kp, a), b in zip(flat, got):
        assert_close(a, b, tolerance,
                     f"{what} {jax.tree_util.keystr(kp)}")


# ---------------------------------------------------------------------------
# one train step per family, against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_steps_match_jax(family):
    """Three AdamW steps of each family's smoke config in f32 from JAX's
    params on the same batches: every loss within 1e-5 relative of JAX's,
    the params after the third step within 1e-3 relative max-abs, AdamW's
    step counter a 0-d int32 tensor at 3."""
    cfg = _cfg(FAMILIES[family])
    jstate, tstate, jl, tl = _run_both(cfg, TCFG, 3, batch=2, seq=8)
    for a, b in zip(jl, tl):
        assert abs(a - b) <= tol("f32") * abs(a), (jl, tl)
    _params_close(jstate[0], tstate[0], STEP_TOL, family)
    step = tstate[1].step
    assert step.dtype == torch.int32 and step.dim() == 0 and int(step) == 3


@pytest.fixture(scope="module")
def dense():
    return _cfg("llama3.2-1b")


def _tiny():
    """``tests/conftest.py::tiny_dense_cfg`` in the port's ModelConfig (bf16,
    untied head)."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                       loss_chunk=0, remat=False)


def test_grad_accum_matches_flat_and_jax(dense):
    """accum 2 over a pre-split (2, 4, S) batch equals accum 1 over the
    flat (8, S) batch (the reference's tolerance), and JAX's accum-2 step
    within the port's step tolerance."""
    t1 = dict(TCFG, grad_accum=1)
    t2 = dict(TCFG, grad_accum=2)
    j0 = _j_state(dense, JTrainConfig(**t2))
    j2, p2, jl2, tl2 = _run_both(dense, t2, 1, j0, batch=8, seq=32,
                                 split=2)
    _, p1, _, tl1 = _run_both(dense, t1, 1, j0, batch=8, seq=32,
                              with_jax=False)
    np.testing.assert_allclose(tl1[0], tl2[0], rtol=1e-3)
    for a, b in zip(util.leaves(p1[0]), util.leaves(p2[0])):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=3e-2, atol=3e-3)
    assert abs(jl2[0] - tl2[0]) <= tol("f32") * abs(jl2[0])
    _params_close(j2[0], p2[0], STEP_TOL, "accum 2")


def test_grad_accum_refuses_an_unsplit_batch(dense):
    step = make_train_step(dense, TrainConfig(**dict(TCFG, grad_accum=2)))
    state = init_train_state(dense, TrainConfig(**TCFG), device="cpu")
    b = make_batch(dense, SyntheticCorpus(dense.vocab_size), 0, 0, 8, 16)
    with pytest.raises(ValueError, match="pre-split"):
        step(*state, b)


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` on the port: 30 steps of the
    tiny dense config, the last 5 losses' mean 0.2 below the first 5's."""
    cfg = _tiny()
    tcfg = TrainConfig(lr=2e-3, warmup=5, total_steps=40)
    state = init_train_state(cfg, tcfg, device="cpu")
    step = make_train_step(cfg, tcfg)
    it = train_iterator(cfg, batch=8, seq=32)
    losses = []
    for _ in range(30):
        *state, m = step(*state, next(it))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::6]


# ---------------------------------------------------------------------------
# remat and the chunked loss
# ---------------------------------------------------------------------------


def _grads(cfg, params, batch):
    from repro_torch.train.loop import _value_and_grad
    return _value_and_grad(cfg, params, batch)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_changes_no_bit(family):
    """``remat=True`` (each scanned unit under activation checkpointing in
    a training forward) gives the loss and every gradient of
    ``remat=False`` bit for bit on the CPU; a chunked loss
    (``loss_chunk`` 8 of 16) the same within 1e-5."""
    cfg = _cfg(FAMILIES[family])
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, SyntheticCorpus(cfg.vocab_size), 0, 0, 2, 16)
    l0, g0 = _grads(dataclasses.replace(cfg, remat=False), params, batch)
    l1, g1 = _grads(dataclasses.replace(cfg, remat=True), params, batch)
    l2, g2 = _grads(dataclasses.replace(cfg, loss_chunk=8), params, batch)
    assert torch.equal(l0, l1)
    for (path, a), b in zip(util.leaves_with_path(g0), util.leaves(g1)):
        assert torch.equal(a, b), path
    assert_close(l0, l2, tol("f32"), "chunked loss")
    for (path, a), b in zip(util.leaves_with_path(g0), util.leaves(g2)):
        assert_close(a, b, tol("f32"), f"chunked loss grad {path}")


def test_remat_runs_under_checkpoint(dense, monkeypatch):
    """With ``training`` and ``remat`` each layer (and each loss chunk)
    runs under ``torch.utils.checkpoint``; a calibration forward
    (``training=False``) under none."""
    calls = []
    real = TT.checkpoint
    monkeypatch.setattr(TT, "checkpoint",
                        lambda f, *a, **k: calls.append(f) or real(f, *a, **k))
    cfg = dataclasses.replace(dense, remat=True, loss_chunk=8)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, SyntheticCorpus(cfg.vocab_size), 0, 0, 2, 16)
    _grads(cfg, params, batch)
    assert len(calls) == cfg.n_layers + 2
    calls.clear()
    with torch.enable_grad():
        TT.loss_fn(params, cfg, batch, training=False)
    assert len(calls) == 2                      # the loss chunks only


def test_collect_stats_ignores_remat(dense):
    """Calibration runs ``training=False``: with ``remat=True`` it collects
    the moments of ``remat=False`` bit for bit (no hook fires twice)."""
    params = TT.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    batches = [make_batch(dense, SyntheticCorpus(dense.vocab_size), 7, i,
                          2, 16) for i in range(2)]
    want = tprecond.collect_stats(
        TT.loss_fn, params, dataclasses.replace(dense, remat=False), batches)
    got = tprecond.collect_stats(
        TT.loss_fn, params, dataclasses.replace(dense, remat=True), batches)
    assert sorted(want.data) == sorted(got.data)
    for key, slot in want.data.items():
        assert got.data[key]["cnt"] == slot["cnt"], key
        assert torch.equal(got.data[key]["sq"], slot["sq"]), key


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,rank", [((64, 96), 1), ((64, 96), 4),
                                        ((3, 20, 48), 2), ((40,), 2)])
def test_compress_leaf_matches_jax(shape, rank):
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    g.flat[0] = 0.0                            # sign(0) is +1 in both
    ccfg = dict(rank=rank, power_iters=6)
    jc = JG.compress_leaf(jnp.asarray(g), JG.CompressConfig(**ccfg))
    tc = TG.compress_leaf(torch.from_numpy(g), TG.CompressConfig(**ccfg))
    assert tc["shape"] == tuple(jc["shape"])
    for k in ("signs", "a", "b"):
        assert_close(jc[k], tc[k], tol("f32"), k)
    assert_close(JG.decompress_leaf(jc), TG.decompress_leaf(tc), tol("f32"),
                 "decompressed")


def test_error_feedback_matches_jax():
    """Six rounds of ``compress_with_error_feedback`` over a tree with a
    leaf below ``min_size`` and a 1-d leaf (both pass through, zero
    error): outputs and error state within 1e-5 of JAX's."""
    rng = np.random.default_rng(1)
    ccfg = dict(rank=2, min_size=1000, power_iters=6)
    jerr = terr = None
    for _ in range(6):
        g = {"w": rng.standard_normal((32, 48)).astype(np.float32),
             "small": rng.standard_normal((8, 8)).astype(np.float32),
             "b": rng.standard_normal((2000,)).astype(np.float32)}
        jout, jerr = JG.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), jerr, JG.CompressConfig(**ccfg))
        tout, terr = TG.compress_with_error_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr,
            TG.CompressConfig(**ccfg))
        for k in g:
            assert_close(jout[k], tout[k], tol("f32"), f"out {k}")
            assert_close(jerr[k], terr[k], tol("f32"), f"err {k}")
    assert torch.equal(tout["small"], torch.from_numpy(g["small"]))
    assert not terr["small"].any() and not terr["b"].any()


@pytest.mark.parametrize("shape", [(1024, 1024), (3, 64, 96), (128,),
                                   (512, 7)])
def test_compression_ratio_matches_jax(shape):
    for rank in (1, 4):
        assert TG.compression_ratio(shape, TG.CompressConfig(rank=rank)) == \
            JG.compression_ratio(shape, JG.CompressConfig(rank=rank))


def test_training_with_compression_converges():
    """The reference's ``test_training_with_compression_converges`` on
    the port, its tiny config widened to d_model 256 so that the embedding,
    head and FFN leaves reach ``min_size`` and compress (rank 2, error
    feedback)."""
    tcfg = TrainConfig(lr=2e-3, warmup=5, total_steps=40,
                       compress_grads=True, compress_rank=2)
    cfg = dataclasses.replace(_tiny(), d_model=256, d_ff=512)
    params, opt, eff = init_train_state(cfg, tcfg, device="cpu")
    assert isinstance(eff, dict)
    step = make_train_step(cfg, tcfg)
    it = train_iterator(cfg, batch=8, seq=32)
    losses = []
    for _ in range(30):
        params, opt, eff, m = step(params, opt, eff, next(it))
        losses.append(float(m["loss"]))
    assert any(e.abs().sum() > 0 for e in util.leaves(eff))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.15


# ---------------------------------------------------------------------------
# data, checkpoints and the Trainer's resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_iterator_matches_jax(family):
    """``train_iterator`` from a start step gives JAX's batches bit for bit
    (the VLM's image embeddings in the config's bf16 too)."""
    cfg = jconfigs.get_smoke(FAMILIES[family])
    jit_ = j_train_iterator(cfg, 2, 8, seed=3, start_step=5)
    tit = train_iterator(cfg, 2, 8, seed=3, start_step=5)
    for _ in range(2):
        jb, tb = next(jit_), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            a = np.asarray(jb[k])
            b = tb[k]
            if b.dtype == torch.bfloat16:
                np.testing.assert_array_equal(a.view(np.int16),
                                              b.view(torch.int16).numpy())
            else:
                np.testing.assert_array_equal(a, b.numpy())


def test_checkpoint_takes_a_training_state(tmp_path, dense):
    """A (params, AdamState, eff) state saves in JAX's leaf order and
    dtypes: the port's restore and JAX's give it back bit for bit."""
    tcfg = TrainConfig(**TCFG)
    state = init_train_state(dense, tcfg, device="cpu")
    state = make_train_step(dense, tcfg)(
        *state, make_batch(dense, SyntheticCorpus(dense.vocab_size), 0, 0,
                           2, 8))[:3]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == []
    mgr.save(1, state)
    meta = mgr.meta(1)
    jstate = jax.eval_shape(lambda: j_init_state(
        dense, JTrainConfig(**TCFG), key=jax.random.PRNGKey(0)))
    assert meta["n_leaves"] == len(jax.tree.leaves(jstate))
    assert meta["dtypes"] == [str(x.dtype) for x in jax.tree.leaves(jstate)]
    step, back = mgr.restore_latest(template=state)
    assert step == 1 and isinstance(back[1], AdamState)
    assert _crc_leaves(back) == _crc_leaves(state)
    leaves_equal(JManager(str(tmp_path)).restore(1, jstate), back)


def _crashing_trainer(cfg, tcfg, d, total, crash_at, every):
    """The fault-tolerant example's drill: attempt 0 crashes at step
    `crash_at`, the restart resumes from the latest checkpoint."""
    def attempt(n):
        mgr = CheckpointManager(d)
        start = mgr.latest_step() or 0
        tr = Trainer(cfg, tcfg, train_iterator(cfg, 4, 16, start_step=start),
                     mgr, ckpt_every=every, log_every=100, device="cpu")
        tr.restore_or_init()
        budget = total - tr.step
        if n == 0:
            budget = min(budget, crash_at - tr.step)
        tr.run(budget)
        if n == 0:
            raise RuntimeError(f"simulated node failure at step {tr.step}")
        attempt.state = tr.state
    assert run_with_restarts(attempt, max_restarts=2, log=lambda m: None) == 1
    return attempt.state


def test_trainer_resume_is_bit_identical(tmp_path):
    """A bf16 teacher checkpointed every 2 steps, crashed at step 5 and
    resumed from step 4 ends at step 8 with the params, AdamW moments and
    step of an uninterrupted 8-step run, bit for bit."""
    cfg = jconfigs.get_smoke("llama3.2-1b")
    tcfg = TrainConfig(lr=1e-3, warmup=2, total_steps=8)
    resumed = _crashing_trainer(cfg, tcfg, str(tmp_path), 8, 5, 2)
    tr = Trainer(cfg, tcfg, train_iterator(cfg, 4, 16), log_every=100,
                 device="cpu")
    tr.run(8)
    assert _crc_leaves(resumed) == _crc_leaves(tr.state)
    assert CheckpointManager(str(tmp_path)).steps() == [4, 6, 8]


@pytest.fixture(scope="module")
def jax_step(dense):
    return jax.jit(j_make_step(dense, JTrainConfig(**TCFG)))


def _log(lines):
    return lambda m: lines.append(m)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_checkpoints_cross_packages(writer, dense, jax_step,
                                            tmp_path):
    """A Trainer checkpoint at step 2 written by one package resumes in the
    other's Trainer: the restored state equal bit for bit, and the next two
    steps' losses within 1e-5 relative of the writer's own (both logging
    the reference's lines)."""
    d = str(tmp_path)
    jt, tt = JTrainConfig(**TCFG), TrainConfig(**TCFG)
    jit_ = lambda s: j_train_iterator(dense, 4, 16, start_step=s)  # noqa
    tit = lambda s: train_iterator(dense, 4, 16, start_step=s)     # noqa
    lines = []

    def jtrainer(mgr, start):
        return JTrainer(dense, jt, jit_(start), mgr, ckpt_every=2,
                        jit_step=jax_step, log_every=1, log_fn=_log(lines))

    def ttrainer(mgr, start):
        return Trainer(dense, tt, tit(start), mgr, ckpt_every=2,
                       log_every=1, log_fn=_log(lines), device="cpu")
    first, second = ((jtrainer, ttrainer) if writer == "jax"
                     else (ttrainer, jtrainer))
    mgr = (JManager if writer == "jax" else CheckpointManager)(d)
    w = first(mgr, 0)
    w.restore_or_init()
    w.run(2)
    mgr2 = (CheckpointManager if writer == "jax" else JManager)(d)
    r = second(mgr2, 2)
    r.restore_or_init()
    assert r.step == 2 and "[trainer] resumed at step 2" in lines
    leaves_equal(w.state, r.state)
    lines.clear()
    for _ in range(2):
        want, got = w.run(1)["loss"], r.run(1)["loss"]
        assert abs(want - got) <= tol("f32") * abs(want), (want, got)
    assert [ln.split()[:2] for ln in lines] == [
        ["[trainer]", f"step={s}"] for s in (3, 3, 4, 4)]


def test_trainer_losses_match_jax_after_resume(dense, jax_step, tmp_path):
    """The metrics of the steps after a JAX-written checkpoint (read at
    full precision, not from the log) within 1e-5 relative of JAX's."""
    d = str(tmp_path)
    jtr = JTrainer(dense, JTrainConfig(**TCFG),
                   j_train_iterator(dense, 4, 16), JManager(d),
                   ckpt_every=2, jit_step=jax_step, log_every=100,
                   log_fn=lambda m: None)
    jtr.restore_or_init()
    jtr.run(2)
    ttr = Trainer(dense, TrainConfig(**TCFG),
                  train_iterator(dense, 4, 16, start_step=2),
                  CheckpointManager(d), log_every=100,
                  log_fn=lambda m: None, device="cpu")
    ttr.restore_or_init()
    for _ in range(2):
        jm, tm = jtr.run(1), ttr.run(1)
        assert abs(jm["loss"] - tm["loss"]) <= tol("f32") * abs(jm["loss"])
        assert abs(jm["lr"] - tm["lr"]) <= tol("f32") * abs(jm["lr"])
    assert ttr.run(0) == {}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_launch_train_resumes_from_its_checkpoints(tmp_path, capsys):
    """``launch.train --smoke --device cpu --ckpt-dir D``: 4 steps, then a
    rerun to 6 resumes at step 4 and trains 2; its step-6 state equals an
    uninterrupted in-process Trainer's bit for bit (inside the warmup of
    20 steps, where the schedule does not depend on ``--steps``); a third
    run trains none."""
    from repro_torch.launch import train as cli
    d = str(tmp_path / "ckpt")
    common = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
              "--ckpt-dir", d, "--ckpt-every", "2", "--log-every", "1"]
    cli.main(common + ["--steps", "4"])
    cli.main(common + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "[trainer] resumed at step 4" in out
    assert "[train] done at step 6" in out
    cli.main(common + ["--steps", "6"])
    assert "[train] already at step 6 >= 6" in capsys.readouterr().out
    cfg = tconfigs.get_smoke("llama3.2-1b")
    tcfg = TrainConfig(lr=3e-4, warmup=20, total_steps=6)
    tr = Trainer(cfg, tcfg, train_iterator(cfg, 4, 16), log_every=100,
                 device="cpu")
    tr.run(6)
    mgr = CheckpointManager(d)
    assert _crc_leaves(mgr.restore(6, tr.state)) == _crc_leaves(tr.state)


def test_launch_train_splits_grad_accum(tmp_path, capsys):
    """``--grad-accum 2 --batch 4`` trains on (2, 2, S) microbatches: its
    checkpoint equals an in-process Trainer's over the same split batches
    (the reference's CLI fails here: ROADMAP §3); a batch that does not
    split refuses."""
    from repro_torch.launch import train as cli
    d = str(tmp_path / "ckpt")
    cli.main(["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
              "--steps", "2", "--grad-accum", "2", "--ckpt-dir", d,
              "--ckpt-every", "2"])
    cfg = tconfigs.get_smoke("llama3.2-1b")
    tcfg = TrainConfig(lr=3e-4, warmup=20, total_steps=2, grad_accum=2)
    tr = Trainer(cfg, tcfg, cli.split_batches(train_iterator(cfg, 4, 16), 2),
                 log_every=100, device="cpu")
    tr.run(2)
    assert _crc_leaves(CheckpointManager(d).restore(2, tr.state)) == \
        _crc_leaves(tr.state)
    with pytest.raises(SystemExit):
        cli.main(["--smoke", "--device", "cpu", "--batch", "5",
                  "--grad-accum", "2"])
    assert "not a multiple" in capsys.readouterr().err


def test_launch_train_refuses_a_mesh(capsys):
    from repro_torch.launch import train as cli
    for mesh in ("single", "multi"):
        with pytest.raises(SystemExit):
            cli.main(["--smoke", "--device", "cpu", "--mesh", mesh])
        assert "ROADMAP item 12" in capsys.readouterr().err


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import quantize as qcli
    from repro_torch.launch import train as tcli
    for main in (lambda: tcli.main(["--smoke", "--steps", "1"]),
                 lambda: qcli.main(["--teacher-steps", "1"]),
                 lambda: init_train_state(_cfg("llama3.2-1b"),
                                          TrainConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()


QUANT_FAST = ["--device", "cpu", "--calib-samples", "4", "--calib-seq",
              "32", "--admm-iters", "2", "--t-pre", "1", "--t-post", "1",
              "--t-glob", "1"]


def _teacher(cfg, steps):
    """The quantize CLI's teacher recipe, in process."""
    tr = Trainer(cfg, TrainConfig(lr=1e-3, warmup=20, total_steps=steps),
                 train_iterator(cfg, 8, 32), log_every=100, device="cpu")
    tr.run(steps)
    return tr.state[0]


def test_quantize_cli_trains_the_teacher(tmp_path, capsys):
    """``launch.quantize --device cpu --teacher-steps 5`` quantizes the
    teacher an in-process Trainer trains under the reference CLI's recipe,
    bit for bit (its report's crc32), and reports both perplexities."""
    from repro_torch.launch import quantize as cli
    out = str(tmp_path / "nq")
    cli.main(["--teacher-steps", "5", "--out", out] + QUANT_FAST)
    assert "teacher at step 5: 5 steps trained" in capsys.readouterr().out
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    want = _teacher(tconfigs.get_smoke("llama3.2-1b"), 5)
    assert rep["teacher"]["crc32"] == _crc_leaves(want)
    assert np.isfinite(rep["ppl_fp"]) and np.isfinite(rep["ppl_q"])


def test_quantize_cli_teacher_ckpt_trains_missing_steps(tmp_path, capsys):
    """``--teacher-ckpt DIR``: 3 steps saved at step 3; a rerun asking 5
    resumes there and trains only 2 (its data skipped to step 3), giving
    the uninterrupted 5-step teacher bit for bit (inside the warmup, where
    the schedule does not depend on the steps asked); a third run trains
    none."""
    from repro_torch.launch import quantize as cli
    d = str(tmp_path / "teacher")
    runs = []
    for steps in (3, 5, 5):
        out = str(tmp_path / f"nq{len(runs)}")
        cli.main(["--teacher-steps", str(steps), "--teacher-ckpt", d,
                  "--out", out] + QUANT_FAST)
        with open(os.path.join(out, "report.json")) as f:
            runs.append(json.load(f)["teacher"])
    text = capsys.readouterr().out
    assert [r["trained_steps"] for r in runs] == [3, 2, 0]
    assert "teacher at step 5: 0 steps trained" in text
    assert "[trainer] resumed at step 3" in text
    want = _crc_leaves(_teacher(tconfigs.get_smoke("llama3.2-1b"), 5))
    assert runs[1]["crc32"] == runs[2]["crc32"] == want


def test_quantize_cli_resumes_a_jax_teacher(tmp_path, capsys):
    """A teacher checkpoint the JAX package's Trainer wrote (the smoke
    config in bf16, 2 steps) is the teacher of ``--teacher-ckpt``: no step
    trained, its crc32 JAX's."""
    from repro_torch.launch import quantize as cli
    d = str(tmp_path / "teacher")
    cfg = jconfigs.get_smoke("llama3.2-1b")
    jtr = JTrainer(cfg, JTrainConfig(lr=1e-3, warmup=20, total_steps=2),
                   j_train_iterator(cfg, 8, 32), JManager(d), ckpt_every=2,
                   log_fn=lambda m: None)
    jtr.restore_or_init()
    jtr.run(2)
    out = str(tmp_path / "nq")
    cli.main(["--teacher-steps", "2", "--teacher-ckpt", d, "--out", out]
             + QUANT_FAST)
    assert "teacher at step 2: 0 steps trained" in capsys.readouterr().out
    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f)["teacher"]["crc32"] == j_crc(jtr.state[0])


# ---------------------------------------------------------------------------
# the arch registry and the api surface
# ---------------------------------------------------------------------------


def test_list_archs_matches_jax():
    assert tapi.list_archs() == japi.list_archs()
    assert tconfigs.list_archs() == jconfigs.list_archs()


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_arch_specs_match_jax(arch):
    """Each arch's shapes, published config and smoke config equal JAX's."""
    assert tapi.shapes_for(arch) == japi.shapes_for(arch)
    spec, jspec = tapi.get_arch(arch), japi.get_arch(arch)
    assert spec.name == jspec.name and spec.shapes == jspec.shapes
    assert dataclasses.asdict(spec.config) == dataclasses.asdict(jspec.config)
    assert dataclasses.asdict(spec.smoke) == dataclasses.asdict(jspec.smoke)


def test_registered_arch_is_served():
    """An arch registered from outside the package is served by
    ``get_config`` / ``get_smoke`` and listed; a re-registration
    refreshes the memoized spec; an unknown name lists the known ones."""
    base = tapi.get_arch("llama3.2-1b")
    name = "test-arch-1b"
    tapi.register_arch(name)(lambda: tapi.ArchSpec(
        name, base.config, base.smoke, ("train_4k",)))
    try:
        assert tconfigs.get_config(name) is base.config
        assert tconfigs.get_smoke(name) is base.smoke
        assert name in tconfigs.list_archs()
        tapi.register_arch(name, tapi.ArchSpec(name, base.smoke, base.smoke,
                                               ()), overwrite=True)
        assert tapi.get_config(name) is base.smoke
        assert tapi.shapes_for(name) == []
    finally:
        tapi.ARCHS.unregister(name)
    with pytest.raises(KeyError, match="llama3.2-1b"):
        tapi.get_config(name)


# the reference's api names the port has no counterpart of: its kernel
# tuning tables (the port's launch planners size every grid from the
# occupancy query and read no table)
NOT_PORTED = {"load_block_table", "load_paged_table"}


def test_api_reexports_the_references_names():
    """Every name of ``repro.api.__all__`` is in ``repro_torch.api`` (and its
    ``__all__``) but the tuning-table loaders: the port has no tile tables,
    since its planners (``binary_matmul._plan_fused``, ``_plan_packed``,
    ``paged_attention._plan_paged``) size each launch from the card's
    occupancy query."""
    have = set(tapi.__all__)
    assert set(japi.__all__) - have == NOT_PORTED
    assert have <= set(japi.__all__)
    for n in have:
        assert hasattr(tapi, n), n
