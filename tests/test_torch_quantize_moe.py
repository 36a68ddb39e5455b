"""The port's quantization pipeline on the MoE family against the JAX
reference: deepseek-v2-lite-16b's smoke config (MLA attention, one
leading dense block, two MoE blocks of 8 experts top-2 plus one shared
expert) in float32, its dense FFN at the shared experts' width (96 for
160, so that the two share JAX's compiled LB-ADMM and the file keeps to
its time), with the ``_FAST`` budget of ``tests/test_torch_quantize.py``
(min_dim 32: w_kr stays FP here; it packs in the block tests of
``tests/test_torch_quantize_experts.py``, which holds the expert building
blocks, and at full width on the card).

Covered, each against the JAX package on the same numpy inputs: the
block order (``dense_layers`` then ``layers``); the calibration taps,
every key JAX taps (MLA's ``attn.*``, the experts' ``moe.*`` with their
per-expert (E, d) moments counted over the capacity rows, the shared
experts' ``moe.shared.*``); the KD loss sequence; the whole pipeline
under JAX's draws and the port's artifact in JAX's
``NanoQuantModel.load``. Tolerances as in ``tests/test_torch_quantize.py``.

The whole pipeline runs with TuneFP skipped in both packages (TuneFP is
held per block in ``tests/test_torch_quantize_experts.py``). With it on,
block 0's TuneFP sees X_q == X_fp: the port's loss is 0 there, JAX's
~7e-6 (its jitted forward against its eager target), and AdamW turns that
noise into full steps; the dense family absorbs it (rows within 6 %), but
here the changed block-0 output re-routes tokens among the experts
downstream, and the MoE blocks' rows then differ by up to 25 % (measured:
pre / STE losses 10 % at layers[0], 25 % at layers[1]; sign bits 84–93 %;
ROADMAP §3). Skipped in both, the rows agree within 1e-4 and the sign
bits all but exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_common import (ROW_REL, check_artifact_in_jax,
                           check_collect_stats, check_kd, check_rows,
                           check_sign_bits, jax_pipeline,
                           one_torch_thread, port_pipeline)  # noqa: F401
from repro import api as japi
from repro.core import pipeline as JP
from repro.data import synthetic as jdata
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import pipeline as TP
from repro_torch.data import synthetic as tdata

ARCH = "deepseek-v2-lite-16b"
QC = dict(target_bpw=1.0, admm_iters=8, t_pre=4, t_post=6, t_glob=4,
          rank_align=32, min_dim=32, skip_tune_fp=True)


@pytest.fixture(scope="module")
def fam():
    cj = dataclasses.replace(japi.get_smoke(ARCH), dtype="float32",
                             dense_d_ff=96)
    ct = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="float32",
                             dense_d_ff=96)
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


def test_blocks_and_taps_match_jax(fam, jax_run):
    """``dense_layers`` then ``layers``, as JAX's; every tap key of JAX's
    calibration (taken by its pipeline run) in the port's, the experts'
    (E, d) moments within 1e-5 and their counts (capacity rows, padding
    included) equal."""
    cj, ct, _, tparams, _, tcal = fam
    fields = ("stack", "idx", "tap_idx", "kind")
    assert [tuple(getattr(b, f) for f in fields) for b in TP.blocks_of(ct)] \
        == [tuple(getattr(b, f) for f in fields) for b in JP.blocks_of(cj)] \
        == [("dense_layers", 0, 0, "attn"), ("layers", 0, 0, "attn"),
            ("layers", 1, 1, "attn")]
    want, got = check_collect_stats(jax_run[4], ct, tparams, tcal)
    for key, slot in got.data.items():
        if key[1] in ("moe.w_gate", "moe.w_up", "moe.w_down"):
            assert tuple(slot["sq"].shape)[0] == ct.n_experts, key
            assert slot["cnt"] % 8 == 0, key          # capacity rows
    assert {k[1] for k in want.data} == {
        "attn.wq", "attn.w_dkv", "attn.w_kr", "attn.wo", "ffn.w_gate",
        "ffn.w_up", "ffn.w_down", "moe.w_gate", "moe.w_up", "moe.w_down",
        "moe.shared.w_gate", "moe.shared.w_up", "moe.shared.w_down"}


def test_kd_matches_jax(fam, jax_run):
    cj, ct, jparams, tparams, jcal, tcal = fam
    jq0, _, _, jkd, _ = jax_run
    tout = check_kd(cj, ct, jparams, tparams, jcal, tcal, jq0, jkd, QC)
    assert tuple(tout["layers"]["moe"]["w_gate"]["s1"].shape) == (2, 8, 96)


def test_pipeline_matches_jax(jax_run, port_model):
    """Report rows and KD losses and packed sign bits under JAX's draws
    (TuneFP skipped: see the module docstring), the stacked experts' words
    included; w_uk / w_uv and the router FP."""
    _, jrep, jq, jkd, _ = jax_run
    check_rows(jrep, jkd, port_model.report, kd_rel=ROW_REL)
    check_sign_bits(jq, port_model.params)
    lp = port_model.params["layers"]
    assert "qu_t" in lp["attn"]["w_dkv"] and "w" in lp["attn"]["w_uk"]
    assert lp["moe"]["router"]["w"].dtype == torch.float32
    assert tuple(lp["moe"]["w_down"]["qu_t"].shape[:2]) == (2, 8)


def test_port_artifact_loads_in_jax(fam, port_model, tmp_path):
    cj, ct, _, _, jcal, _ = fam
    check_artifact_in_jax(port_model, cj, ct, np.asarray(jcal[0]["tokens"]),
                          str(tmp_path / "art"))
