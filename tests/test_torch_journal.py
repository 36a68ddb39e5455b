"""The port's crash-safe quantization (``checkpoint.journal``,
``checkpoint.manager``'s keyed save, ``quant.faults``,
``quant.preflight``, ``nanoquant_quantize(journal_dir=, resume=,
faults=)`` and ``launch.quantize --supervise``) against the JAX package,
on the CPU at ``benchmarks/quant_chaos.py``'s size (``CHAOS_CFG``: 2
dense layers, d 64, its smoke budget and calibration).

Covered: the chaos benchmark's five races on the port's pipeline
(baseline, kill_resume, orphan_ckpt, fallback, journal_guard); the
reference's journal and preflight cases (``tests/test_pipeline.py``: a
different run refused, a corrupt entry and a missing block checkpoint
named, a torn final append tolerated, the ladder walked and exhausted,
``resume`` without a journal rejected, bad inputs refused); a fault
schedule's seams, ``fired`` and ``summary()`` against JAX's plan; across
the packages, a journal and its keyed block checkpoints written by either
one validated and loaded by the other with ``run_fingerprint`` equal; the
supervised CLI drill (a crash at block 1, a restart, a resume) against
an uninterrupted run. Every comparison of artifacts is bit for bit
(``_crc_leaves``); report rows compare exactly, ``wall_s`` and
``seconds`` excluded.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_common import one_torch_thread  # noqa: F401
from benchmarks.quant_chaos import CHAOS_CFG, _setup
from repro.checkpoint import journal as JJ
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.quant import faults as JF
from repro_torch.api import NanoQuantModel
from repro_torch.checkpoint import journal as TJ
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import numpy_from_tensor, params_from_numpy
from repro_torch.core import pipeline as TP
from repro_torch.core import util as tutil
from repro_torch.core.admm import QuantizationError
from repro_torch.data import synthetic as tdata
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.quant import faults as TF
from repro_torch.quant import preflight as tpreflight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS = CHAOS_CFG.n_layers
# the reference's shorter budget of its ladder and resume tests
SHORT = dict(admm_iters=4, t_pre=2, t_post=2, t_glob=2)


@pytest.fixture(scope="module")
def chaos():
    """The chaos benchmark's smoke setup in both packages: (port config,
    params, calibration, QuantConfig, JAX's params, calibration,
    QuantConfig)."""
    jparams, jcal, jq = _setup(smoke=True)
    ct = ModelConfig(**dataclasses.asdict(CHAOS_CFG))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tcal = tdata.calib_batches(ct, 8, 32, batch=4,
                               corpus=tdata.SyntheticCorpus(ct.vocab_size))
    qc = TP.QuantConfig(**dataclasses.asdict(jq))
    return ct, tparams, tcal, qc, jparams, jcal, jq


def _run(chaos, qcfg=None, **kw):
    ct, tparams, tcal, qc = chaos[:4]
    return TP.nanoquant_quantize(tparams, ct, tcal, qcfg or qc,
                                 verbose=False, **kw)


def _identity(report):
    """The comparable run identity: everything but the clocks."""
    return json.dumps({k: v for k, v in report.items()
                       if k not in ("wall_s", "seconds")}, sort_keys=True)


def _fingerprint(chaos, qcfg=None, calib=None):
    ct, tparams, tcal, qc = chaos[:4]
    return TJ.run_fingerprint(tparams, ct, qcfg or qc,
                              tcal if calib is None else calib, N_BLOCKS)


@pytest.fixture(scope="module")
def baseline(chaos, tmp_path_factory):
    """One uninterrupted journaled run: (journal dir, params, their crc,
    report)."""
    d = str(tmp_path_factory.mktemp("journal_base"))
    qp, rep = _run(chaos, journal_dir=d)
    return d, qp, TJ._crc_leaves(qp), rep


def _journal_copy(src, tmp_path):
    dst = str(tmp_path / "journal")
    shutil.copytree(src, dst)
    return dst


# ---------------------------------------------------------------------------
# the chaos benchmark's five races (benchmarks/quant_chaos.py)
# ---------------------------------------------------------------------------


@pytest.mark.chaos_quant
def test_race_baseline(chaos, baseline):
    """The journaled run is the unjournaled run, bit for bit, and its
    journal validates with every block."""
    d, _, crc0, rep0 = baseline
    qp, rep = _run(chaos)
    assert TJ._crc_leaves(qp) == crc0 and _identity(rep) == _identity(rep0)
    done = TJ.QuantJournal(d).entries_for_resume(_fingerprint(chaos))
    assert sorted(done) == list(range(N_BLOCKS))
    assert [done[i]["row"] for i in range(N_BLOCKS)] == rep0["blocks"]


@pytest.mark.chaos_quant
@pytest.mark.parametrize("kind", ["crash_block", "crash_after_save"])
def test_race_kill_resume_and_orphan_ckpt(chaos, baseline, tmp_path, kind):
    """kill_resume (a crash when block 1 starts) and orphan_ckpt (a crash
    between block 1's checkpoint and its journal line): the resume skips
    block 0, (re)does block 1 and gives the uninterrupted artifact and
    report."""
    _, _, crc0, rep0 = baseline
    d = str(tmp_path / "j")
    plan = TF.QuantFaultPlan([TF.QuantFault(block=1, kind=kind)])
    with pytest.raises(TF.InjectedPipelineCrash, match="block 1"):
        _run(chaos, journal_dir=d, faults=plan)
    assert plan.fired == [(1, kind)]
    assert TJ.QuantJournal(d).n_completed_blocks() == 1
    beats = []
    qp, rep = _run(chaos, journal_dir=d, resume=True, heartbeat=beats.append)
    assert TJ._crc_leaves(qp) == crc0 and _identity(rep) == _identity(rep0)
    assert beats[0] == "block=0/2 layers[0] resumed"
    assert beats[1] == "block=1/2 layers[1] start"


@pytest.mark.chaos_quant
def test_race_fallback(chaos, tmp_path):
    """NaN latents at block 0 / linear 0: the run falls down the ladder,
    the report and the journal record the switch, and the artifact saves,
    loads, generates and evaluates finitely."""
    ct, _, tcal, qc = chaos[:4]
    d = str(tmp_path / "j")
    plan = TF.QuantFaultPlan([TF.QuantFault(block=0, kind="nan_init",
                                            linear=0, iteration=3)])
    qp, rep = _run(chaos, journal_dir=d, faults=plan)
    row0 = rep["blocks"][0]
    with open(f"{d}/journal.jsonl") as f:
        lines = [json.loads(line)["payload"] for line in f if line.strip()]
    jrow0 = next(p["row"] for p in lines
                 if p.get("kind") == "block" and p["bi"] == 0)
    assert row0["init_method"] != qc.init_method
    assert row0["fallbacks"][0]["method"] == qc.init_method
    assert row0["fallbacks"][0]["iteration"] == 3
    assert jrow0 == row0
    model = NanoQuantModel(qp, ct, dataclasses.asdict(qc), rep)
    model.save(str(tmp_path / "artifact"))
    loaded = NanoQuantModel.load(str(tmp_path / "artifact"), device="cpu")
    outs = loaded.generate([np.arange(8)], max_new_tokens=4)
    assert len(outs[0]) > 0
    assert np.isfinite(loaded.perplexity(tcal))


@pytest.mark.chaos_quant
def test_race_journal_guard(chaos, tmp_path):
    """Block 0's journal line corrupted in place (valid JSON, wrong
    crc32), then a crash at block 1: the resume refuses, naming
    layers[0]."""
    d = str(tmp_path / "j")
    plan = TF.QuantFaultPlan([TF.QuantFault(block=0, kind="corrupt_journal"),
                              TF.QuantFault(block=1, kind="crash_block")])
    with pytest.raises(TF.InjectedPipelineCrash):
        _run(chaos, journal_dir=d, faults=plan)
    with pytest.raises(TJ.JournalError, match=r"layers\[0\]") as ei:
        _run(chaos, journal_dir=d, resume=True)
    assert ei.value.block == "layers[0]"


# ---------------------------------------------------------------------------
# the reference's journal, ladder and preflight cases (tests/test_pipeline.py)
# ---------------------------------------------------------------------------


def test_resume_refuses_different_run(chaos, baseline):
    d = baseline[0]
    other = dataclasses.replace(chaos[3], target_bpw=0.8)
    with pytest.raises(TJ.JournalError, match="quant_config"):
        TJ.QuantJournal(d).entries_for_resume(_fingerprint(chaos, other))
    with pytest.raises(TJ.JournalError, match="calib_crc"):
        TJ.QuantJournal(d).entries_for_resume(
            _fingerprint(chaos, calib=chaos[2][:1]))
    with pytest.raises(TJ.JournalError, match="quant_config"):
        _run(chaos, dataclasses.replace(chaos[3], seed=1), journal_dir=d,
             resume=True)


@pytest.mark.chaos_quant
def test_corrupt_journal_entry_names_block(chaos, baseline, tmp_path):
    j = TJ.QuantJournal(_journal_copy(baseline[0], tmp_path))
    TF._corrupt_last_line(j.path)          # the last line: block 1's entry
    with pytest.raises(TJ.JournalError, match=r"layers\[1\]") as ei:
        j.entries_for_resume(_fingerprint(chaos))
    assert ei.value.block == "layers[1]"


def test_missing_block_checkpoint_names_block(chaos, baseline, tmp_path):
    d = _journal_copy(baseline[0], tmp_path)
    shutil.rmtree(f"{d}/blocks/step_00000000")
    with pytest.raises(TJ.JournalError, match=r"layers\[0\]") as ei:
        TJ.QuantJournal(d).entries_for_resume(_fingerprint(chaos))
    assert ei.value.block == "layers[0]"


def test_torn_final_append_tolerated(chaos, baseline, tmp_path):
    """A truncated trailing line (a crash mid-append) is dropped and the
    file truncated back to its valid prefix; not an error."""
    j = TJ.QuantJournal(_journal_copy(baseline[0], tmp_path))
    with open(j.path, "ab") as f:
        f.write(b'{"payload": {"kind": "block", "bi"')
    assert sorted(j.entries_for_resume(_fingerprint(chaos))) == [0, 1]
    with open(j.path, "rb") as f:
        assert f.read().endswith(b"}\n")


@pytest.mark.chaos_quant
def test_nan_init_walks_fallback_ladder(chaos):
    qc = dataclasses.replace(chaos[3], **SHORT)
    plan = TF.QuantFaultPlan([TF.QuantFault(block=0, kind="nan_init",
                                            linear=1, iteration=5)])
    qp, rep = _run(chaos, qc, faults=plan)
    row = rep["blocks"][0]
    assert row["init_method"] == "dbf_admm"
    assert row["fallbacks"][0]["method"] == "lb_admm"
    assert row["fallbacks"][0]["iteration"] == 5
    assert rep["blocks"][1]["fallbacks"] == []
    assert torch.isfinite(TT.forward(qp, chaos[0],
                                     chaos[2][0]["tokens"])).all()


@pytest.mark.chaos_quant
def test_fallback_ladder_exhaustion_is_structured(chaos):
    qc = dataclasses.replace(chaos[3], fallback_inits="", **SHORT)
    plan = TF.QuantFaultPlan([TF.QuantFault(block=0, kind="nan_init",
                                            linear=0, iteration=2)])
    with pytest.raises(QuantizationError) as ei:
        _run(chaos, qc, faults=plan)
    e = ei.value
    assert e.block == "layers[0]" and "exhausted" in e.reason
    assert e.iteration == 2


def test_resume_without_journal_dir_rejected(chaos):
    with pytest.raises(ValueError, match="journal_dir"):
        _run(chaos, resume=True)


def test_preflight_accepts_good_inputs(chaos):
    """The dense calibration, and the audio family's (B, S, K) frames
    (which the reference's two-dimensional check refuses); the free
    memory read is the host's for CPU params."""
    ct, tparams, tcal = chaos[:3]
    info = tpreflight.preflight(tparams, ct, tcal)
    assert info["n_batches"] == len(tcal) and info["est_block_bytes"] > 0
    assert info["device"] == "cpu" and info["available_bytes"] > 0
    from repro_torch.configs import get_smoke
    audio = get_smoke("musicgen-medium")
    frames = tdata.calib_batches(audio, 4, 16, batch=2)
    apar = TT.init_params(audio, torch.Generator().manual_seed(0), "cpu")
    assert tpreflight.preflight(apar, audio, frames)["n_calib_tokens"] == \
        4 * 16 * audio.n_codebooks


def test_preflight_rejects_bad_inputs(chaos):
    ct, tparams, tcal = chaos[:3]
    PreflightError = tpreflight.PreflightError
    with pytest.raises(PreflightError, match="no calibration"):
        tpreflight.preflight(tparams, ct, [])
    bad = [dict(tcal[0], tokens=tcal[0]["tokens"] + ct.vocab_size)]
    with pytest.raises(PreflightError, match="vocab_size"):
        tpreflight.preflight(tparams, ct, bad)
    mixed = [tcal[0], {k: v[:, :16] for k, v in tcal[0].items()}]
    with pytest.raises(PreflightError, match="sequence lengths"):
        tpreflight.preflight(tparams, ct, mixed)
    floats = [dict(tcal[0], tokens=tcal[0]["tokens"].float())]
    with pytest.raises(PreflightError, match="not an integer"):
        tpreflight.preflight(tparams, ct, floats)
    nan = dict(tparams, embed=torch.full_like(tparams["embed"], np.nan))
    with pytest.raises(PreflightError, match="non-finite values in: embed"):
        tpreflight.preflight(nan, ct, tcal)


def test_preflight_refuses_a_working_set_past_free_memory(chaos,
                                                         monkeypatch):
    ct, tparams, tcal = chaos[:3]
    monkeypatch.setattr(tpreflight, "_available_bytes", lambda dev: 1024)
    with pytest.raises(tpreflight.PreflightError,
                       match="free memory of cpu"):
        tpreflight.preflight(tparams, ct, tcal)


# ---------------------------------------------------------------------------
# the fault plan against JAX's
# ---------------------------------------------------------------------------

SCHEDULE = [(1, "crash_block", 0, 0), (0, "nan_init", 1, 5),
            (2, "crash_after_save", 0, 0), (0, "corrupt_journal", 0, 0),
            (3, "crash_after_journal", 0, 0), (0, "nan_init", 2, 1),
            (9, "crash_block", 0, 0)]


def test_fault_plan_matches_jax(tmp_path):
    """The same schedule through every seam of both packages' plans, in
    the pipeline's order for blocks 0-3: the same faults fire at the same
    seams, the same crashes are raised, the same journal bytes corrupted,
    and ``fired``, ``pending_faults`` and ``summary()`` are equal."""
    got = []
    for F in (JF, TF):
        path = tmp_path / F.__name__ / "journal.jsonl"
        path.parent.mkdir()
        path.write_text('{"payload": {"bi": 12}, "crc": 345}\n' * 2)
        journal = types.SimpleNamespace(path=str(path))
        plan = F.QuantFaultPlan([F.QuantFault(b, k, linear=li, iteration=it)
                                 for b, k, li, it in SCHEDULE])
        log = []
        for bi in range(4):
            seams = (("start", lambda: plan.on_block_start(bi)),
                     *((f"poison {li}", lambda li=li: plan.poison_init(bi, li))
                       for li in range(3)),
                     ("save", lambda: plan.after_block_save(bi)),
                     ("append", lambda: plan.on_journal_append(bi, journal)))
            for seam, call in seams:
                try:
                    r = call()
                    log.append((bi, seam, None if r is None
                                else dataclasses.asdict(r)))
                except F.InjectedPipelineCrash as e:
                    log.append((bi, seam, "crash", e.block, e.seam, str(e)))
        with pytest.raises(ValueError, match="unknown quant fault kind"):
            F.QuantFault(0, "boom")
        got.append((log, plan.fired, plan.pending_faults, plan.summary(),
                    path.read_text()))
    assert got[0] == got[1]
    assert got[1][2] == 1 and got[1][3]["unfired"] == [
        {"block": 9, "kind": "crash_block", "linear": 0, "iteration": 0}]


# ---------------------------------------------------------------------------
# across the packages: the journal, its block store and the fingerprint
# ---------------------------------------------------------------------------


def _jax_fingerprint(chaos):
    _, _, _, _, jparams, jcal, jq = chaos
    return JJ.run_fingerprint(jparams, CHAOS_CFG, jq, jcal, N_BLOCKS)


def _same_bits(jtree, ttree):
    jflat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(a)
             for kp, a in jax.tree_util.tree_leaves_with_path(jtree)}
    tflat = dict(tutil.leaves_with_path(ttree))
    assert sorted(jflat) == sorted(tflat)
    for path, a in jflat.items():
        b = tflat[path]
        assert a.shape == tuple(b.shape), path
        assert TJ._crc_leaves({path.rsplit("/", 1)[-1]: b}) == \
            JJ._crc_leaves({path.rsplit("/", 1)[-1]: a}), path


def test_fingerprint_matches_jax(chaos):
    """``run_fingerprint`` of the same teacher and calibration, the port's
    int64 tokens and JAX's int32 ones, f32 and bf16 params alike, is
    JAX's value for value."""
    assert _fingerprint(chaos) == _jax_fingerprint(chaos)
    ct, tparams = chaos[:2]
    jparams = chaos[4]
    bf = dataclasses.replace(ct, dtype="bfloat16")
    jbf = dataclasses.replace(CHAOS_CFG, dtype="bfloat16")
    cast = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), jparams)
    tcast = params_from_numpy(jax.tree.map(np.asarray, cast), "cpu")
    assert TJ._crc_leaves(tcast) == JJ._crc_leaves(cast)
    assert TJ.run_fingerprint(tcast, bf, chaos[3], chaos[2], 2) == \
        JJ.run_fingerprint(cast, jbf, chaos[6], chaos[5], 2)


def test_port_journal_resumes_in_jax(chaos, baseline):
    """The port's journal passes JAX's ``entries_for_resume`` under JAX's
    own fingerprint, and each keyed block checkpoint restores in JAX's
    ``restore_keyed`` to the port's block, bit for bit (packed words as
    uint32); the blocks before KD are the packed linears of the run's
    artifact."""
    d, qp = baseline[:2]
    done = JJ.QuantJournal(d).entries_for_resume(_jax_fingerprint(chaos))
    assert sorted(done) == list(range(N_BLOCKS))
    for bi in range(N_BLOCKS):
        jb = JManager(f"{d}/blocks", keep=10 ** 9).restore_keyed(bi)
        assert jb["attn"]["wq"]["qu_t"].dtype == jax.numpy.uint32
        tb = TJ.QuantJournal(d).load_block(bi)
        _same_bits(jb, tb)
        for path, leaf in tutil.leaves_with_path(tb):
            if path.rsplit("/", 1)[-1] in ("qv", "qu_t"):
                assert torch.equal(leaf, dict(tutil.leaves_with_path(
                    tutil.tree_index(qp["layers"], bi)))[path]), path


def test_jax_journal_resumes_in_port(chaos, baseline, tmp_path):
    """A journal written through JAX's ``QuantJournal`` (its header under
    JAX's fingerprint, the port's finished blocks saved keyed by JAX's
    manager) validates in the port's ``entries_for_resume`` and resumes
    the port's pipeline to the uninterrupted artifact and report."""
    d0, _, crc0, rep0 = baseline
    port = TJ.QuantJournal(d0).entries_for_resume(_fingerprint(chaos))
    d = str(tmp_path / "jax_journal")
    jj = JJ.QuantJournal(d)
    jj.start(_jax_fingerprint(chaos))
    for bi in range(N_BLOCKS):
        block = TJ.QuantJournal(d0).load_block(bi)
        extra = jj.save_block(bi, f"layers[{bi}]", _to_jax(block))
        entry = {k: port[bi][k] for k in ("bi", "block", "ranks", "row")}
        jj.append_block(dict(entry, **extra))
    done = TJ.QuantJournal(d).entries_for_resume(_fingerprint(chaos))
    assert sorted(done) == list(range(N_BLOCKS))
    qp, rep = _run(chaos, journal_dir=d, resume=True)
    assert TJ._crc_leaves(qp) == crc0 and _identity(rep) == _identity(rep0)


def _to_jax(tree, packed=False):
    """A port tree as JAX arrays of the same bits (bf16 through
    ml_dtypes, packed words as uint32)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v, k in ("qv", "qu_t")) for k, v in tree.items()}
    arr, name = numpy_from_tensor(tree, "uint32" if packed else None)
    if name == "bfloat16":
        arr = arr.view(ml_dtypes.bfloat16)
    return jax.numpy.asarray(arr)


def test_keyed_checkpoint_keep_and_crashed_saves(tmp_path):
    """``keep`` bounds the steps kept, a crashed save's temporary
    directory is swept by the next save, and a keyed save stores bf16 as
    its words and packed words as uint32 with the JAX manager reading
    both back bit for bit."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"b": {"qu_t": torch.tensor([[-1, 7]], dtype=torch.int32),
                  "s1": torch.ones(2)},
            "a": torch.arange(3, dtype=torch.float32).to(torch.bfloat16)}
    os.makedirs(tmp_path / ".tmp-9-1")
    for step in range(3):
        mgr.save(step, tree, keyed=True)
    assert mgr.steps() == [1, 2]
    assert not any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
    meta = mgr.meta(2)
    assert meta["keypaths"] == ["a", "b/qu_t", "b/s1"]
    assert meta["dtypes"] == ["bfloat16", "uint32", "float32"]
    back = mgr.restore_keyed(2)
    for path, leaf in tutil.leaves_with_path(tree):
        got = dict(tutil.leaves_with_path(back))[path]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), path
    _same_bits(JManager(str(tmp_path)).restore_keyed(2), tree)


# ---------------------------------------------------------------------------
# the supervised CLI drill
# ---------------------------------------------------------------------------


def test_supervised_cli_drill(tmp_path, capsys):
    """``launch.quantize --journal-dir J --crash-at-block 1 --supervise``
    on the CPU: the first child crashes when block 1 starts, the
    supervisor restarts it with ``--resume``, it resumes one journaled
    block, and its artifact equals an uninterrupted run's bit for bit."""
    from repro_torch.launch import quantize as cli
    common = ["--device", "cpu", "--teacher-steps", "0", "--calib-samples",
              "4", "--calib-seq", "32", "--admm-iters", "4", "--t-pre", "2",
              "--t-post", "2", "--t-glob", "2"]
    drill = str(tmp_path / "drill")
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quantize", *common,
         "--journal-dir", str(tmp_path / "j"), "--crash-at-block", "1",
         "--supervise", "--hang-timeout", "120", "--out", drill],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert out.count("[supervisor] launching") == 2
    assert "injected pipeline crash at block 1 (block start)" in out
    assert "resuming: 1/2 blocks journaled" in out
    assert "[quant] heartbeat block=0/2 layers[0] resumed" in out
    assert "[supervisor] child finished cleanly" in out
    plain = str(tmp_path / "plain")
    cli.main(common + ["--out", plain])
    a, b = (NanoQuantModel.load(p, device="cpu") for p in (drill, plain))
    assert TJ._crc_leaves(a.params) == TJ._crc_leaves(b.params)
    assert a.report["blocks"] == b.report["blocks"]
