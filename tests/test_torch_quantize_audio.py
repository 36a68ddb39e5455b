"""The port's quantization pipeline on the audio family against the JAX
reference: musicgen-medium's smoke config (2 layers, d 64, 4 heads of 16,
d_ff 128, 4 codebooks of 128) in float32 over (B, S, 4) frames, with the
``_FAST`` budget of ``tests/test_torch_quantize.py`` (min_dim 32).

Covered, each against the JAX package on the same numpy inputs: the
calibration batches (identical arrays: K streams from one generator in
JAX's order), the taps (every key, sums and row counts), one "attn"
block's TuneFP and STE, the KD loss sequence (one softmax over the 4 ×
128 logits of a frame jointly, as JAX's ``_kd_loss_chunked`` takes it
over the (d, K·V) head), the whole pipeline under JAX's random draws and
the port's artifact in JAX's ``NanoQuantModel.load``. Tolerances as in
``tests/test_torch_quantize.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_common import (check_artifact_in_jax, check_block_tune,
                           check_collect_stats, check_kd, check_rows,
                           check_sign_bits, jax_pipeline,
                           one_torch_thread, port_pipeline)  # noqa: F401
from repro import api as japi
from repro.core import pipeline as JP
from repro.core import util as jutil
from repro.data import synthetic as jdata
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import pipeline as TP
from repro_torch.data import synthetic as tdata
from repro_torch.models import transformer as TT

ARCH = "musicgen-medium"
QC = dict(target_bpw=1.0, admm_iters=8, t_pre=4, t_post=6, t_glob=4,
          rank_align=32, min_dim=32)


@pytest.fixture(scope="module")
def fam():
    cj = dataclasses.replace(japi.get_smoke(ARCH), dtype="float32")
    ct = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), cj)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcal = jdata.calib_batches(cj, n_samples=8, seq=32, batch=4)
    tcal = tdata.calib_batches(ct, n_samples=8, seq=32, batch=4)
    return cj, ct, jparams, tparams, jcal, tcal


@pytest.fixture(scope="module")
def jax_run(fam):
    cj, _, jparams, _, jcal, _ = fam
    return jax_pipeline(cj, jparams, jcal, QC)


@pytest.fixture(scope="module")
def port_model(fam):
    _, ct, _, tparams, _, tcal = fam
    return port_pipeline(ct, tparams, tcal, QC)


def test_calib_batches_identical_arrays(fam):
    _, ct, _, _, jcal, tcal = fam
    assert len(jcal) == len(tcal) == 2
    for a, b in zip(jcal, tcal):
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        assert tuple(b["tokens"].shape) == (4, 32, 4)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    other = tdata.calib_batches(ct, 12, 40, batch=3, seed=5)
    want = jdata.calib_batches(japi.get_smoke(ARCH), 12, 40, batch=3, seed=5)
    for a, b in zip(want, other):
        np.testing.assert_array_equal(np.asarray(a["labels"]),
                                      b["labels"].numpy())


def test_blocks_and_taps_match_jax(fam, jax_run):
    """Two "attn" blocks; every tap of JAX's calibration (taken by its
    pipeline run), each counting frames."""
    _, ct, _, tparams, _, tcal = fam
    assert [(b.stack, b.idx, b.kind) for b in TP.blocks_of(ct)] == \
        [("layers", i, "attn") for i in range(2)]
    want, got = check_collect_stats(jax_run[4], ct, tparams, tcal)
    assert len(want.data) == 2 * 7 * 2
    for slot in got.data.values():
        assert slot["cnt"] == 8 * 32         # frames, not codebook ids


def test_attn_block_tune_fp_and_ste_match_jax(fam):
    cj, ct, jparams, _, _, _ = fam
    check_block_tune(cj, ct, jutil.tree_index(jparams["layers"], 1), "attn",
                     QC)


def test_kd_loss_takes_one_softmax_over_every_codebook(fam):
    """``_kd_loss_chunked`` on the same hidden states: JAX's value within
    1e-5, and not the mean of per-codebook KLs."""
    cj, ct, jparams, tparams, _, _ = fam
    rng = np.random.default_rng(5)
    hs, ht = (rng.standard_normal((2, 6, 64)).astype(np.float32)
              for _ in range(2))
    want = JP._kd_loss_chunked(hs, ht, jparams, jparams, cj, 1.0)
    got = TP._kd_loss_chunked(torch.from_numpy(hs), torch.from_numpy(ht),
                              tparams, tparams, ct, 1.0)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    w = TT._head_w(tparams, ct)
    zs = (torch.from_numpy(hs) @ w).unflatten(-1, (4, ct.vocab_size))
    zt = (torch.from_numpy(ht) @ w).unflatten(-1, (4, ct.vocab_size))
    per_book = (torch.softmax(zt, -1) * (torch.log_softmax(zt, -1)
                                         - torch.log_softmax(zs, -1))
                ).sum(-1).mean()
    assert abs(float(per_book) - float(got)) > 1e-3


def test_kd_matches_jax(fam, jax_run):
    cj, ct, jparams, tparams, jcal, tcal = fam
    jq0, _, _, jkd, _ = jax_run
    check_kd(cj, ct, jparams, tparams, jcal, tcal, jq0, jkd, QC)


def test_pipeline_matches_jax(jax_run, port_model):
    _, jrep, jq, jkd, _ = jax_run
    check_rows(jrep, jkd, port_model.report)
    check_sign_bits(jq, port_model.params)


def test_port_artifact_loads_in_jax(fam, port_model, tmp_path):
    cj, ct, _, _, jcal, _ = fam
    check_artifact_in_jax(port_model, cj, ct, np.asarray(jcal[0]["tokens"]),
                          str(tmp_path / "art"))
