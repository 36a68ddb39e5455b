"""The port's quantization pipeline on the SSM family against the JAX
reference: mamba2-370m's smoke config (3 Mamba2 blocks, d 64, d_inner 128
in 8 heads of 16, state 16, chunk 16) in float32, packed at ``min_dim``
16 (wz, wx, wB, wC and out_proj pack; wdt, 64 -> 8, stays FP), with the
``_FAST`` budget of ``tests/test_torch_quantize.py``. Calibration
sequences of 40 tokens, so the SSD scan pads its last chunk.

Covered, each against the JAX package on the same numpy inputs: the
calibration taps of the mixer's six projections (every key JAX taps, sums
and row counts), one "mamba" block's TuneFP and STE (loss sequences and
tuned leaves), the SSD scan's gradient (finite where the reference's is
NaN), the KD loss sequence, the whole pipeline under JAX's random draws
(report rows, packed sign bits) and the port's artifact in JAX's
``NanoQuantModel.load`` (identical leaves, f32 logits). Tolerances
as in ``tests/test_torch_quantize.py``: 1e-5 relative where both packages
do the same f32 arithmetic, the whole-pipeline gates of its docstring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, check_artifact_in_jax,
                           check_block_tune, check_collect_stats, check_kd,
                           check_rows, check_sign_bits, jax_pipeline,
                           one_torch_thread, port_pipeline,  # noqa: F401
                           tol)
from repro import api as japi
from repro.core import util as jutil
from repro.data import synthetic as jdata
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import pipeline as TP
from repro_torch.data import synthetic as tdata
from repro_torch.models import layers as TL

ARCH = "mamba2-370m"
QC = dict(target_bpw=1.0, admm_iters=8, t_pre=4, t_post=6, t_glob=4,
          rank_align=32, min_dim=16)
MIXER = ("wz", "wx", "wB", "wC", "wdt", "out_proj")


@pytest.fixture(scope="module")
def fam():
    cj = dataclasses.replace(japi.get_smoke(ARCH), dtype="float32")
    ct = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), cj)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jcal = jdata.calib_batches(cj, n_samples=8, seq=40, batch=4)
    tcal = tdata.calib_batches(ct, n_samples=8, seq=40, batch=4)
    return cj, ct, jparams, tparams, jcal, tcal


@pytest.fixture(scope="module")
def jax_run(fam):
    cj, _, jparams, _, jcal, _ = fam
    return jax_pipeline(cj, jparams, jcal, QC)


@pytest.fixture(scope="module")
def port_model(fam):
    _, ct, _, tparams, _, tcal = fam
    return port_pipeline(ct, tparams, tcal, QC)


def test_blocks_and_taps_match_jax(fam, jax_run):
    """Three "mamba" blocks over ``layers``; every tap of the mixer's
    projections in JAX's calibration (taken by its pipeline run), so no
    identity preconditioner by a missing name."""
    _, ct, _, tparams, _, tcal = fam
    assert [(b.stack, b.idx, b.kind) for b in TP.blocks_of(ct)] == \
        [("layers", i, "mamba") for i in range(3)]
    want, _ = check_collect_stats(jax_run[4], ct, tparams, tcal)
    names = {k[1] for k in want.data}
    assert names == {f"mixer.{n}" for n in MIXER}
    assert len(want.data) == 3 * 6 * 2


def test_mamba_block_tune_fp_and_ste_match_jax(fam):
    cj, ct, jparams, _, _, _ = fam
    bp = jutil.tree_index(jparams["layers"], 1)
    pre, ste = check_block_tune(cj, ct, bp, "mamba", QC, seq=40)
    assert len(pre) == QC["t_pre"] and len(ste) == QC["t_post"]


def test_ssd_gradient_masks_before_the_exp():
    """``ssd_chunked``'s values and, where JAX's are finite, gradients
    equal JAX's; where the masked upper triangle's exp overflows (large
    dt · |A| over a long chunk, as at mamba2-370m's chunk 256), JAX's
    gradient is NaN and the port's finite (it masks before the exp)."""
    rng = np.random.default_rng(9)
    B, S, H, P, N = 1, 64, 4, 8, 8
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, 1, N)).astype(np.float32)
              for _ in range(2))
    for dt_scale, chunk, finite in ((0.01, 16, True), (0.5, 64, False)):
        dt = (np.abs(rng.standard_normal((B, S, H))) * dt_scale).astype(
            np.float32)

        def jloss(d):
            return JL.ssd_chunked(jnp.asarray(xh), d, jnp.asarray(A),
                                  jnp.asarray(Bm), jnp.asarray(Cm),
                                  chunk)[0].sum()
        jy = JL.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)),
                            chunk)[0]
        jg = jax.grad(jloss)(jnp.asarray(dt))
        td = torch.from_numpy(dt).requires_grad_()
        ty = TL.ssd_chunked(torch.from_numpy(xh), td, torch.from_numpy(A),
                            torch.from_numpy(Bm), torch.from_numpy(Cm),
                            chunk)[0]
        ty.sum().backward()
        assert_close(jy, ty, tol("f32"), f"values, chunk {chunk}")
        assert torch.isfinite(td.grad).all()
        assert bool(jnp.isfinite(jg).all()) == finite
        if finite:
            assert_close(jg, td.grad, tol("f32"), f"d dt, chunk {chunk}")


def test_kd_matches_jax(fam, jax_run):
    cj, ct, jparams, tparams, jcal, tcal = fam
    jq0, _, _, jkd, _ = jax_run
    check_kd(cj, ct, jparams, tparams, jcal, tcal, jq0, jkd, QC)


def test_pipeline_matches_jax(jax_run, port_model):
    """Report rows and packed sign bits under JAX's draws; wdt stays FP
    in both."""
    _, jrep, jq, jkd, _ = jax_run
    check_rows(jrep, jkd, port_model.report)
    check_sign_bits(jq, port_model.params)
    mixer = port_model.params["layers"]["mixer"]
    assert "w" in mixer["wdt"] and "qu_t" in mixer["wB"]


def test_port_artifact_loads_in_jax(fam, port_model, tmp_path):
    cj, ct, _, _, jcal, _ = fam
    check_artifact_in_jax(port_model, cj, ct, np.asarray(jcal[0]["tokens"]),
                          str(tmp_path / "art"))
