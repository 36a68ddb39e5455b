"""The port's quantization pipeline on the VLM family against the JAX
reference: llama-3.2-vision-90b's smoke config (4 layers in 2 groups of
one self-attention block and one gated cross-attention block, d 64, 4
heads of 16 over 2 kv heads, d_ff 128, 16 image tokens) in float32,
packed at ``min_dim`` 16 (every linear packs, the cross blocks' wk / wv
64 -> 32 among them), with the ``_FAST`` budget of
``tests/test_torch_quantize.py``.

The teacher is JAX's ``init_params`` with its cross blocks' gates redrawn
under ``testing.GATE_LAWS`` (``with_gates``) in the numpy params both
packages receive: JAX's zero gates make every cross block the identity,
its linears' output gradients zero and so their preconditioners the
identity. One test keeps JAX's zeros.

Covered, each against the JAX package on the same numpy inputs:
``make_batch``'s image embeddings (bit for bit), the blocks and their
labels, the calibration taps (every key: the self layers under their flat
index, ``xattn.*`` under the group, wk / wv over the image rows), the
cross block's forward, LB-ADMM and packing of the cross block's linears
under JAX's draws, TuneFP and STE of a self and a cross block, the KD loss
sequence, the whole pipeline under JAX's draws, the artifact in JAX's
``NanoQuantModel.load``, journals crossing the packages both ways,
preflight's refusals and ``launch.quantize --arch llama-3.2-vision-90b``
on the CPU.

Gates. 1e-5 relative where both packages do the same f32 arithmetic. The
whole pipeline runs with TuneFP skipped in both packages (as the MoE's and
the hybrid's tests do: the first block sees X_q == X_fp, where the port's
TuneFP loss is exactly 0 and JAX's jit noise becomes AdamW steps) and
TuneFP is held block by block instead. Measured with it skipped: every
report row within 1.2e-6 relative, the KD losses within 2.2e-7, every
packed sign bit equal — gated at 3e-4, 3e-4 and 98 % per leaf.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, bits, check_artifact_in_jax,
                           check_block_tune, check_collect_stats, check_kd,
                           jax_draws, jax_pipeline, jkey, leaves_equal,
                           one_torch_thread,  # noqa: F401
                           sign_shares, t_np, to_np, tol)
from repro import api as japi
from repro.checkpoint import journal as JJ
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import pipeline as JP
from repro.core import precond as jprecond
from repro.data import synthetic as jdata
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import journal as TJ
from repro_torch.convert import numpy_from_tensor, params_from_numpy
from repro_torch.core import admm as tadmm
from repro_torch.core import pipeline as TP
from repro_torch.core import util as tutil
from repro_torch.data import synthetic as tdata
from repro_torch.models import transformer as TT
from repro_torch.quant import preflight as tpreflight
from repro_torch.testing import with_gates

ARCH = "llama-3.2-vision-90b"
QC = dict(target_bpw=1.0, admm_iters=8, t_pre=4, t_post=6, t_glob=4,
          rank_align=32, min_dim=16)
# the whole pipeline's budget: TuneFP skipped (module docstring)
QC_PIPE = dict(QC, skip_tune_fp=True)
ROW_REL, KD_REL, SIGN_FLOOR = 3e-4, 3e-4, 0.98
N_BLOCKS = 4
CROSS = ("xattn.wq", "xattn.wk", "xattn.wv", "xattn.wo")


def _configs():
    cj = dataclasses.replace(japi.get_smoke(ARCH), dtype="float32")
    ct = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    return cj, ct


def _inputs(gates: bool):
    """(JAX params, port params, JAX calibration, port calibration): JAX's
    teacher from seed 0, with `gates` redrawn under GATE_LAWS."""
    cj, ct = _configs()
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), cj))
    if gates:
        tree = with_gates(tree, 5)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, "cpu")
    jcal = jdata.calib_batches(cj, n_samples=8, seq=32, batch=4)
    tcal = tdata.calib_batches(ct, n_samples=8, seq=32, batch=4)
    return jparams, tparams, jcal, tcal


@pytest.fixture(scope="module")
def fam():
    return _configs() + _inputs(gates=True)


@pytest.fixture(scope="module")
def jax_run(fam):
    cj, _, jparams, _, jcal, _ = fam
    return jax_pipeline(cj, jparams, jcal, QC_PIPE)


def _port(ct, tparams, tcal, qc=QC_PIPE, **kw):
    """The port's pipeline under JAX's draws: (params, report)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadmm, "_rand_range_init", jax_draws)
        return TP.nanoquant_quantize(tparams, ct, tcal, TP.QuantConfig(**qc),
                                     verbose=False, **kw)


@pytest.fixture(scope="module")
def port_run(fam, tmp_path_factory):
    """The port's pipeline under JAX's draws, journaled: (journal dir,
    params, report)."""
    _, ct, _, tparams, _, tcal = fam
    d = str(tmp_path_factory.mktemp("vlm_journal"))
    return (d,) + _port(ct, tparams, tcal, journal_dir=d)


def _fields(blocks):
    return [(b.stack, b.idx, b.tap_idx, b.kind) for b in blocks]


def test_make_batch_image_embeds_match_jax():
    """The image embeddings, drawn after the tokens from the step's
    generator, are JAX's bit for bit in f32 and in the config's bf16."""
    for dtype in ("float32", "bfloat16"):
        cj = dataclasses.replace(japi.get_smoke(ARCH), dtype=dtype)
        ct = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype=dtype)
        corpus = tdata.SyntheticCorpus(ct.vocab_size)
        want = jdata.make_batch(cj, jdata.SyntheticCorpus(cj.vocab_size), 3,
                                2, 2, 12)
        got = tdata.make_batch(ct, corpus, 3, 2, 2, 12)
        assert tuple(got["image_embeds"].shape) == (2, 16, 64)
        np.testing.assert_array_equal(bits(want["image_embeds"]),
                                      bits(got["image_embeds"]))
        np.testing.assert_array_equal(np.asarray(want["tokens"]),
                                      got["tokens"].numpy())


def test_blocks_and_labels_match_jax(fam, jax_run, port_run):
    """``blocks_of``: each group's self block at (g, 0), tapped at its flat
    index, then its cross block; the report labels JAX's
    (``self_layers[(0, 0)]``), the ranks keyed alike."""
    cj, ct = fam[:2]
    want = _fields(JP.blocks_of(cj))
    assert _fields(TP.blocks_of(ct)) == want == [
        ("self_layers", (0, 0), 0, "attn"), ("cross_layers", 0, 0, "cross"),
        ("self_layers", (1, 0), 1, "attn"), ("cross_layers", 1, 1, "cross")]
    labels = [r["block"] for r in port_run[2]["blocks"]]
    assert labels == [r["block"] for r in jax_run[1]["blocks"]]
    assert labels[0] == "self_layers[(0, 0)]"
    assert port_run[2]["ranks"] == jax_run[1]["ranks"]


def test_taps_match_jax(fam, jax_run):
    """Every tap key of JAX's calibration with its rows and sums at 1e-5:
    a self layer's under its flat index, the cross block's ``xattn.*`` and
    FFN under its group; wk / wv over the 8 × 16 image rows, wq / wo over
    the 8 × 32 token rows; with the drawn gates no "out" moment is 0."""
    _, ct, _, tparams, _, tcal = fam
    want, _ = check_collect_stats(jax_run[4], ct, tparams, tcal)
    keys = set(want.data)
    for g in range(2):
        for name in CROSS:
            for field in ("in", "out"):
                slot = want.data[("cross_layers", name, field, g)]
                rows = 8 * 16 if name in ("xattn.wk", "xattn.wv") else 8 * 32
                assert slot["cnt"] == rows, (name, field)
                assert float(np.min(np.asarray(slot["sq"]))) > 0, name
        assert ("self_layers", "attn.wq", "in", g) in keys
    assert {k[3] for k in keys if k[0] == "self_layers"} == {0, 1}
    assert len(keys) == 2 * (7 + 7) * 2


def test_cross_apply_matches_jax(fam):
    """``make_apply("cross")``: the image K/V projected from the context's
    embeddings, then the gated cross block, at 1e-5."""
    cj, ct, jparams, tparams = fam[:4]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 9, cj.d_model)).astype(np.float32)
    img = rng.standard_normal((3, 16, cj.d_model)).astype(np.float32)
    jbp = jax.tree.map(lambda l: l[1], jparams["cross_layers"])
    tbp = tutil.tree_index(tparams["cross_layers"], 1)
    want = JP.make_apply(cj, "cross")(jbp, jnp.asarray(x),
                                      {"image_embeds": jnp.asarray(img)})
    got = TP.make_apply(ct, "cross")(tbp, t_np(x),
                                     {"image_embeds": t_np(img)})
    assert_close(want, got, tol("f32"), "cross block")
    # the drawn gates let the block work: far from the identity
    assert float(np.abs(to_np(got) - x).max()) > 0.1 * np.abs(x).max()


def test_cross_block_admm_and_packing_match_jax(fam, jax_run):
    """Cross block 0 (block 1): each linear's preconditioners from the
    calibration stats, its LB-ADMM latents from JAX's draws at the same key
    path (balanced) at 1e-5, and JAX's latents packed by both packages to
    the same words and scales."""
    from repro_torch.core import precond as tprecond
    cj, ct, jparams, tparams, _, tcal = fam
    jstats = jax_run[4]
    tstats = tprecond.collect_stats(TT.loss_fn, tparams, ct, tcal)
    bref = TP.blocks_of(ct)[1]
    jbp = jax.tree.map(lambda l: l[0], jparams["cross_layers"])
    tbp = bref.get(tparams)
    jq, tq = JP.QuantConfig(**QC), TP.QuantConfig(**QC)
    paths = TP.linear_paths(tbp, tq.min_dim)
    assert paths == JP.linear_paths(jbp, jq.min_dim)
    assert [".".join(p) for p in paths if p[0] == "xattn"] == \
        ["xattn.wk", "xattn.wo", "xattn.wq", "xattn.wv"]
    for li, path in enumerate(paths):
        name = ".".join(path)
        jp, tp = TP._get_path(jbp, path), TP._get_path(tbp, path)
        din, dout = tp["w"].shape
        jd = jprecond.preconditioners_for(jstats, "cross_layers", name, 0,
                                          din, dout, tq.gamma)
        td = tprecond.preconditioners_for(tstats, "cross_layers", name, 0,
                                          din, dout, tq.gamma)
        for a, b in zip(jd, td):
            assert_close(a, b, tol("f32"), f"{name} preconditioner")
        jlat, jr = JP._init_latent(jp, *jd, jq, jkey((0, 1, li)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tadmm, "_rand_range_init", jax_draws)
            tlat, tr = TP._init_latent(tp, *td, tq, (0, 1, li))
        assert jr == tr
        for k in ("lu", "lv", "s1", "s2"):
            assert_close(jlat[k], tlat[k], tol("f32"), f"{name} {k}")
        want = JP._pack_latent(jlat)
        got = TP._pack_latent({k: t_np(np.asarray(v))
                               for k, v in jlat.items()})
        for k in ("qv", "qu_t"):
            np.testing.assert_array_equal(bits(want[k]), bits(got[k]))
        for k in ("s1", "s2"):
            assert_close(want[k], got[k], tol("f32"), f"{name} packed {k}")


@pytest.mark.parametrize("stack", ["self_layers", "cross_layers"])
def test_block_tune_fp_and_ste_match_jax(fam, stack):
    """TuneFP then STE of the second self block and of the second cross
    block (over 8 rows of seeded image embeddings, sliced with each
    microbatch) from the same inputs, at 1e-5 (``check_block_tune``)."""
    cj, ct, jparams = fam[:3]
    if stack == "self_layers":
        bp = jax.tree.map(lambda l: l[1, 0], jparams["self_layers"])
        kind, ctx = "attn", None
    else:
        bp = jax.tree.map(lambda l: l[1], jparams["cross_layers"])
        img = np.random.default_rng(12).standard_normal(
            (8, 16, cj.d_model)).astype(np.float32)
        kind, ctx = "cross", {"image_embeds": img}
    pre, ste = check_block_tune(cj, ct, bp, kind, QC, ctx=ctx)
    assert len(pre) == QC["t_pre"] and len(ste) == QC["t_post"]


def test_kd_matches_jax(fam, jax_run):
    """KD over batches with image embeddings: JAX's loss sequence at 1e-5
    from JAX's packed model, every scale moved (``check_kd``)."""
    cj, ct, jparams, tparams, jcal, tcal = fam
    check_kd(cj, ct, jparams, tparams, jcal, tcal, jax_run[0], jax_run[3], QC)


def test_pipeline_matches_jax(jax_run, port_run):
    """Report rows, KD losses and packed sign bits under JAX's draws,
    TuneFP skipped (the gates of the module docstring); the self layers
    come back with their two leading axes."""
    _, jrep, jq, jkd = jax_run[:4]
    qp, rep = port_run[1:]
    assert len(rep["blocks"]) == len(jrep["blocks"]) == N_BLOCKS
    for a, b in zip(jrep["blocks"], rep["blocks"]):
        assert b["block"] == a["block"] and b["init_method"] == "lb_admm"
        assert a["pre_loss"] is None and b["pre_loss"] is None
        for k in ("ste_loss", "block_err"):
            assert b[k] == pytest.approx(a[k], rel=ROW_REL), (a["block"], k)
    np.testing.assert_allclose(rep["kd_losses"], jkd, rtol=KD_REL)
    shares = sign_shares(jq, qp)
    assert min(shares.values()) >= SIGN_FLOOR, shares
    assert qp["self_layers"]["attn"]["wq"]["qu_t"].dim() == 4
    assert qp["cross_layers"]["xattn"]["wk"]["qu_t"].dim() == 3
    # the cross blocks did work: their errors differ from the block before
    errs = [r["block_err"] for r in rep["blocks"]]
    assert errs[1] != errs[0] and errs[3] != errs[2]


def test_zero_gates_match_jax():
    """JAX's own teacher, zero gates: each cross block is the identity, so
    its linears' output moments are 0 in both packages' taps (their
    preconditioners the identity), and the port's pipeline, TuneFP skipped,
    gives each cross block the error of the self block before it, its
    linears packed from identity preconditioners."""
    from repro_torch.core import precond as tprecond
    cj, ct = _configs()
    jparams, tparams, jcal, tcal = _inputs(gates=False)
    jstats = jprecond.collect_stats(JT.loss_fn, jparams, cj, jcal)
    got, _ = check_collect_stats(jstats, ct, tparams, tcal)
    for g in range(2):
        for name in CROSS + ("ffn.w_gate", "ffn.w_up", "ffn.w_down"):
            assert not np.asarray(
                got.data[("cross_layers", name, "out", g)]["sq"]).any(), name
        d_in, d_out = tprecond.preconditioners_for(
            tprecond.collect_stats(TT.loss_fn, tparams, ct, tcal),
            "cross_layers", "ffn.w_up", g, 64, 128, 0.2)
        assert torch.equal(d_out, torch.ones(128))
    _, rep = _port(ct, tparams, tcal, qc=dict(QC_PIPE, t_glob=0))
    errs = [r["block_err"] for r in rep["blocks"]]
    assert errs[1] == errs[0] and errs[3] == errs[2]


def test_port_artifact_loads_in_jax(fam, port_run, tmp_path):
    """The port's VLM artifact in JAX's ``NanoQuantModel.load``: its leaves
    bit for bit and JAX's f32 forward with an image equal to the port's."""
    from repro_torch.api import NanoQuantModel
    cj, ct, _, _, jcal, _ = fam
    _, qp, rep = port_run
    model = NanoQuantModel(qp, ct, dataclasses.asdict(
        TP.QuantConfig(**QC_PIPE)), rep)
    check_artifact_in_jax(model, cj, ct, np.asarray(jcal[0]["tokens"]),
                          str(tmp_path / "art"),
                          image=np.asarray(jcal[0]["image_embeds"]))


def _fingerprints(fam):
    cj, ct, jparams, tparams, jcal, tcal = fam
    qc = TP.QuantConfig(**QC_PIPE)
    return (JJ.run_fingerprint(jparams, cj, JP.QuantConfig(**QC_PIPE), jcal,
                               N_BLOCKS),
            TJ.run_fingerprint(tparams, ct, qc, tcal, N_BLOCKS))


def test_port_journal_resumes_in_jax(fam, port_run):
    """The port's VLM journal (image embeddings in the calibration's crc,
    the self blocks' tuple-indexed labels) passes JAX's
    ``entries_for_resume`` under JAX's own fingerprint, equal to the
    port's, and every block restores in JAX's ``restore_keyed`` to the
    port's leaves, bit for bit."""
    d = port_run[0]
    jfp, tfp = _fingerprints(fam)
    assert jfp == tfp
    done = JJ.QuantJournal(d).entries_for_resume(jfp)
    assert sorted(done) == list(range(N_BLOCKS))
    assert done[0]["block"] == "self_layers[(0, 0)]"
    for bi in range(N_BLOCKS):
        leaves_equal(JManager(f"{d}/blocks", keep=10 ** 9).restore_keyed(bi),
                     TJ.QuantJournal(d).load_block(bi))


def _to_jax(tree, packed=False):
    if isinstance(tree, dict):
        return {k: _to_jax(v, k in ("qv", "qu_t")) for k, v in tree.items()}
    arr, name = numpy_from_tensor(tree, "uint32" if packed else None)
    if name == "bfloat16":
        arr = arr.view(ml_dtypes.bfloat16)
    return jnp.asarray(arr)


def test_jax_journal_resumes_in_port(fam, port_run, tmp_path):
    """A VLM journal written through JAX's ``QuantJournal`` (its header
    under JAX's fingerprint, the port's blocks saved keyed by JAX's
    manager) resumes the port's pipeline: every block reloaded, the params
    and the report rows, ranks and KD losses those of the uninterrupted
    run, bit for bit."""
    d0, qp0, rep0 = port_run
    jfp = _fingerprints(fam)[0]
    entries = TJ.QuantJournal(d0).entries_for_resume(_fingerprints(fam)[1])
    d = str(tmp_path / "jax_journal")
    jj = JJ.QuantJournal(d)
    jj.start(jfp)
    for bi in range(N_BLOCKS):
        block = TJ.QuantJournal(d0).load_block(bi)
        extra = jj.save_block(bi, entries[bi]["block"], _to_jax(block))
        jj.append_block(dict({k: entries[bi][k] for k in
                              ("bi", "block", "ranks", "row")}, **extra))
    qp, rep = _port(fam[1], fam[3], fam[5], journal_dir=d, resume=True)
    assert TJ._crc_leaves(qp) == TJ._crc_leaves(qp0)
    keep = ("blocks", "ranks", "kd_losses")
    assert json.dumps({k: rep[k] for k in keep}, sort_keys=True) == \
        json.dumps({k: rep0[k] for k in keep}, sort_keys=True)


@pytest.mark.parametrize("fault", ["missing", "nan"])
def test_preflight_refuses_bad_image_embeds(fam, fault):
    """Preflight refuses a VLM batch without ``image_embeds`` and one with
    a NaN in them, with the reference's messages, and counts the image
    embeddings in its working-set estimate."""
    _, ct, _, tparams, _, tcal = fam
    ok = tpreflight.preflight(tparams, ct, tcal)
    no_img = [{k: v for k, v in b.items() if k != "image_embeds"}
              for b in tcal]
    img_bytes = sum(b["image_embeds"].numel() * 4 for b in tcal)
    assert ok["est_block_bytes"] == \
        tpreflight.estimate_block_bytes(ct, no_img) + img_bytes
    bad = [dict(b) for b in tcal]
    if fault == "missing":
        del bad[1]["image_embeds"]
        msg = "calibration batch 1: vlm family needs 'image_embeds'"
    else:
        img = bad[1]["image_embeds"].clone()
        img[0, 3, 5] = float("nan")
        bad[1]["image_embeds"] = img
        msg = "calibration batch 1: image_embeds contain non-finite values"
    with pytest.raises(tpreflight.PreflightError, match=msg):
        tpreflight.preflight(tparams, ct, bad)


def test_quantize_cli_vlm(tmp_path, capsys):
    """``launch.quantize --arch llama-3.2-vision-90b --device cpu`` at smoke
    size (preflight on): the artifact loads in both packages, and its
    forward with an image is finite."""
    from repro_torch.api import NanoQuantModel
    from repro_torch.launch import quantize as cli
    out = str(tmp_path / "nq")
    cli.main(["--arch", ARCH, "--device", "cpu", "--teacher-steps", "0",
              "--calib-samples", "4",
              "--calib-seq", "32", "--admm-iters", "4", "--t-pre", "2",
              "--t-post", "2", "--t-glob", "2", "--out", out])
    text = capsys.readouterr().out
    for line in ("preflight ok", "FP teacher ppl", "NanoQuant ppl",
                 f"saved to {out}"):
        assert line in text, line
    model = NanoQuantModel.load(out, device="cpu")
    assert model.cfg.family == "vlm" and model.quantized
    toks = torch.from_numpy(np.arange(16).reshape(2, 8) % 256)
    img = torch.randn(2, 16, 64).to(torch.bfloat16)
    assert torch.isfinite(TT.forward(model.params, model.cfg, toks,
                                     img).float()).all()
    j = japi.NanoQuantModel.load(out)
    assert j.quantized and j.cfg.name == model.cfg.name
