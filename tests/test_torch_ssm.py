"""The port's SSM family (Mamba2) against the JAX reference, on
mamba2-370m's smoke config (3 layers, d 64, d_inner 128, 8 heads of 16,
state 16, conv 4, chunk 16) packed with ``min_dim=16``, so that wz, wx,
wB, wC and out_proj are packed and wdt (64 -> 8) stays FP.

Covered: ``_causal_conv``; ``ssd_chunked`` at S = 7 (under one chunk),
16 (one chunk) and 40 (three chunks, the last zero-padded); ``_conv_step``;
``mamba2`` on its full-sequence and recurrent routes, on the plain oracles
and on the kernel wrappers' dispatch; the model's forward, its
exact-length prefill (1 token: the recurrent step; 2 tokens: a conv ring
shorter than K-1; 21 tokens: past a chunk) and its decode step over the
per-slot state with an inactive slot; the full-size template; the merge;
the state engine against JAX's engine (mid-flight admissions, slot reuse,
admission and decode steps), its refusals (no pool, no prefix index, no
speculation in either package), a 2-token prompt against the greedy
continuation of JAX's ``T.forward`` on a fresh and on a reused slot (the
reference's engine keeps a stale ring row there, ROADMAP §3); the chaos
plan against JAX's engine; drain; artifacts in both directions;
``launch.serve --arch mamba2-370m``.

Inputs come from ``np.random.default_rng``; tolerances are
``_torch_common.tol`` (relative max-abs f32 1e-5, bf16 3e-2) per layer
and 1e-4 for whole-model logits (``tests/test_torch_model.py``); f32
engine tokens are identical.
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

from _torch_common import (assert_close, cast_jax, check_forward,
                           draw_prompts, f32, flat_templates, jax_engine,
                           jax_tree, leaves_equal, packed_model, pair,
                           same_tokens, serve_engine, tol, torch_params)
from repro import api as japi
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve.faults import Fault as JFault
from repro.serve.faults import FaultPlan as JFaultPlan
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig, check_family
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import FaultPlan, RequestError, paging
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.testing import chaos_plan, chaos_trace, drive_chaos

ARCH = "mamba2-370m"
MIN_DIM = 16                 # packs wB / wC (64 -> 16); wdt (64 -> 8) FP
LOGITS_TOL = 1e-4
MODES = {"ref": (ops.KernelPolicy(mode="ref"), jops.KernelPolicy(mode="ref")),
         "kernels": (ops.KernelPolicy(mode="cuda"),
                     jops.KernelPolicy(mode="pallas", interpret=True))}
PACKED = ("wz", "wx", "wB", "wC", "out_proj")
STATE = ("ssm", "conv_x", "conv_B", "conv_C")


def _configs():
    cj, ct = f32(jconfigs.get_smoke(ARCH)), f32(tconfigs.get_smoke(ARCH))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.family == "ssm" and ct.ssm_chunk == 16 and ct.ssm_conv == 4
    return cj, ct


def _model(seed=0):
    cj, ct = _configs()
    tree = packed_model(ct, seed=seed, min_dim=MIN_DIM)
    return cj, ct, tree, jax_tree(tree), torch_params(tree)


@pytest.fixture(scope="module")
def model():
    return _model()


def _mixer(ct, dt):
    """Layer 0's mixer of a seeded model as the pair (JAX, port) in `dt`
    (FP leaves cast, packed leaves and A_log / D / dt_bias as stored)."""
    tree = packed_model(ct, seed=3, min_dim=MIN_DIM)["layers"]["mixer"]
    p = {k: {kk: np.ascontiguousarray(vv[0]) for kk, vv in v.items()}
         if isinstance(v, dict) else np.ascontiguousarray(v[0])
         for k, v in tree.items()}
    assert all("qu_t" in p[k] for k in PACKED) and set(p["wdt"]) == {"w"}
    jp, tp = jax_tree(p), params_from_numpy(p, "cpu")
    if dt == "bf16":
        jp = cast_jax(jp, jnp.bfloat16)
        tp = params_from_numpy(tp, "cpu", torch.bfloat16)
        assert tp["A_log"].dtype == tp["D"].dtype == tp["dt_bias"].dtype \
            == torch.float32 and tp["conv_x"].dtype == torch.bfloat16
    return jp, tp


# ---------------------------------------------------------------------------
# the layer functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_and_conv_step_match_jax(dt):
    """The full-sequence conv (f32 tap sums in order, cast back to x's
    dtype) and the one-token step from a (B, K-1, C) ring (f32 out, the
    ring shifted by one row)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (0.2 * rng.standard_normal((4, 24))).astype(np.float32)
    b = (0.02 * rng.standard_normal((24,))).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = pair(x, dt), pair(w, dt), pair(b, dt)
    want = JL._causal_conv(jx, jw, jb)
    got = TL._causal_conv(tx, tw, tb)
    assert got.dtype == tx.dtype
    assert_close(want, got, tol(dt), f"causal conv {dt}")
    buf = rng.standard_normal((2, 3, 24)).astype(np.float32)
    (jbuf, tbuf), (jn, tn) = pair(buf, dt), pair(x[:, :1], dt)
    wy, wbuf = JL._conv_step(jbuf, jn, jw, jb)
    gy, gbuf = TL._conv_step(tbuf, tn, tw, tb)
    assert gy.dtype == torch.float32 and gbuf.dtype == tbuf.dtype
    assert_close(wy, gy, tol(dt), f"conv step {dt}")
    np.testing.assert_array_equal(np.asarray(wbuf, np.float32),
                                  gbuf.float().numpy())


@pytest.mark.parametrize("S", [7, 16, 40])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_chunked_matches_jax(S, dt):
    """Under one chunk (no padding), exactly one, and three chunks with
    the last zero-padded (dt = 0 on the pad: no decay, no input): y and
    the final state, with 2 groups over 4 heads."""
    rng = np.random.default_rng(S)
    B, H, P, G, N = 2, 4, 8, 2, 16
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 3)
                   ).astype(np.float32)
    A = -np.exp(rng.uniform(0, np.log(16), size=(H,))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    (jx, tx), (jB, tB), (jC, tC) = pair(xh, dt), pair(Bm, dt), pair(Cm, dt)
    want_y, want_st = jax.jit(lambda *a: JL.ssd_chunked(*a, 16))(
        jx, jnp.asarray(dtv), jnp.asarray(A), jB, jC)
    got_y, got_st = TL.ssd_chunked(tx, torch.from_numpy(dtv),
                                   torch.from_numpy(A), tB, tC, 16)
    assert got_y.dtype == got_st.dtype == torch.float32
    assert tuple(got_y.shape) == (B, S, H, P)
    assert tuple(got_st.shape) == (B, H, P, N)
    assert_close(want_y, got_y, tol("f32"), f"ssd y S={S} {dt}")
    assert_close(want_st, got_st, tol("f32"), f"ssd state S={S} {dt}")


@pytest.mark.parametrize("route,dt,mode", [
    (r, dt, "ref") for r in ("full", "step") for dt in ("f32", "bf16")]
    + [(r, "f32", "kernels") for r in ("full", "step")])
def test_mamba2_matches_jax(route, dt, mode):
    """The mixer on the full-sequence route (S = 21, past one chunk;
    its terminal state against JAX's ``transformer._mamba_prefill``) and
    the recurrent step (S = 1 from a random state): the output and the
    new state, on the plain oracles and, in f32, on the kernel wrappers'
    dispatch against JAX's Pallas kernels in interpret mode."""
    cj, ct = _configs()
    if dt == "bf16":
        cj, ct = (dataclasses.replace(c, dtype="bfloat16") for c in (cj, ct))
    jp, tp = _mixer(ct, dt)
    rng = np.random.default_rng(5)
    S = 21 if route == "full" else 1
    x = rng.standard_normal((3, S, ct.d_model)).astype(np.float32)
    jx, tx = pair(x, dt)
    jst = tst = None
    if route == "step":
        gn = ct.ssm_groups * ct.ssm_state
        st = {"ssm": rng.standard_normal(
                  (3, ct.ssm_heads, ct.ssm_head_dim, ct.ssm_state)
                  ).astype(np.float32),
              "conv_x": rng.standard_normal((3, 3, ct.d_inner)
                                            ).astype(np.float32),
              "conv_B": rng.standard_normal((3, 3, gn)).astype(np.float32),
              "conv_C": rng.standard_normal((3, 3, gn)).astype(np.float32)}
        jst = {k: pair(v, None if k == "ssm" else dt)[0]
               for k, v in st.items()}
        tst = {k: pair(v, None if k == "ssm" else dt)[1]
               for k, v in st.items()}
    tpol, jpol = MODES[mode]
    with jops.kernel_policy(jpol):
        want, jnew = jax.jit(lambda p, x, s: JL.mamba2(p, cj, x, s))(
            jp, jx, jst)
        if route == "full":
            assert jnew is None
            zeros = JT.init_cache(cj, 3, 8)["layers"]
            _, jnew = jax.jit(lambda p, x: JT._mamba_prefill(
                p, cj, x, {k: v[0] for k, v in zeros.items()}))(jp, jx)
    with ops.kernel_policy(tpol):
        got, tnew = TL.mamba2(tp, ct, tx, tst)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_close(want, got, tol(dt), f"mamba2 {route} {dt} {mode}")
    for k in STATE:
        assert tnew[k].dtype == (torch.float32 if k == "ssm" else tx.dtype)
        assert_close(jnew[k], tnew[k], tol(dt), f"mamba2 state {k} {dt}")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_matches_jax(model, dt):
    """The full-sequence forward (S = 11): f32 on the kernel wrappers'
    dispatch; the bf16 model (FP leaves cast, A_log / D / dt_bias kept
    f32) on the plain oracles against JAX's bf16 model."""
    cj, ct, tree, jparams, tparams = model
    if dt == "f32":
        check_forward(cj, jparams, tparams, MODES["kernels"][0], LOGITS_TOL,
                      f"{cj.name} f32")
        return
    m = NanoQuantModel.from_numpy(tree, dataclasses.replace(
        ct, dtype="bfloat16"), device="cpu", dtype=torch.bfloat16)
    mixer = m.params["layers"]["mixer"]
    assert mixer["A_log"].dtype == mixer["dt_bias"].dtype == torch.float32
    assert mixer["conv_x"].dtype == mixer["wdt"]["w"].dtype == torch.bfloat16
    check_forward(dataclasses.replace(cj, dtype="bfloat16"),
                  cast_jax(jparams, jnp.bfloat16), m.params,
                  MODES["ref"][0], tol("bf16"), f"{cj.name} bf16")


@pytest.fixture(scope="module")
def jax_results():
    """JAX's model results (its plain XLA path), each computed once and
    held against the port on both of its kernel modes."""
    return {}


@pytest.mark.parametrize("n", [1, 2, 21])
@pytest.mark.parametrize("mode", list(MODES))
def test_exact_length_prefill_matches_jax(model, jax_results, n, mode):
    """Logits and the terminal state of an exact-length prefill: one token
    takes the recurrent step (as the reference's S == 1 branch), 2 tokens
    leave a conv ring shorter than K-1 = 3 (the port right-aligns the
    2 rows behind a zero row; the reference's state holds the 2 rows
    alone), 21 run the chunked SSD past one chunk."""
    cj, ct, _, jparams, tparams = model
    toks = np.random.default_rng(n).integers(
        0, ct.vocab_size, size=(1, n)).astype(np.int32)
    if ("prefill", n) not in jax_results:
        jax_results["prefill", n] = jax.jit(lambda p, t: JT.prefill(
            p, cj, t, JT.init_cache(cj, 1, 24)))(jparams, toks)
    want, jcache = jax_results["prefill", n]
    with ops.kernel_policy(MODES[mode][0]):
        got, tcache = TT.prefill(tparams, ct, torch.from_numpy(toks).long(),
                                 TT.init_cache(ct, 1, 24, "cpu"))
    assert_close(want, got, LOGITS_TOL, f"prefill logits n={n} {mode}")
    st = tcache["layers"]
    assert set(st) == set(jcache["layers"]) == set(STATE)
    assert st["ssm"].dtype == torch.float32
    assert tuple(st["conv_x"].shape) == (3, 1, 3, ct.d_inner)
    for k in STATE:
        a, b = np.asarray(jcache["layers"][k]), st[k].numpy()
        if k != "ssm" and a.shape[2] < b.shape[2]:
            assert not b[:, :, :b.shape[2] - a.shape[2]].any()
            b = b[:, :, b.shape[2] - a.shape[2]:]
        assert_close(a, b, tol("f32"), f"prefill state {k} n={n} {mode}")


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_matches_jax(model, jax_results, mode):
    """One decode step of three slots from a random state: logits and the
    new state of the active slots against JAX's; the inactive slot's
    state stays bit for bit (``active``)."""
    cj, ct, _, jparams, tparams = model
    rng = np.random.default_rng(7)
    cache = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in TT.init_cache(ct, 3, 8, "cpu")["layers"].items()}
    tok = rng.integers(0, ct.vocab_size, size=(3, 1)).astype(np.int32)
    pos = np.array([5, 9, 0], np.int32)
    if "decode" not in jax_results:
        jax_results["decode"] = jax.jit(
            lambda p, t, c, q: JT.decode_step(p, cj, t, c, q))(
                jparams, tok, {"layers": {k: jnp.asarray(v)
                                          for k, v in cache.items()}}, pos)
    want, jc = jax_results["decode"]
    tc = {"layers": {k: torch.from_numpy(v.copy()) for k, v in cache.items()}}
    active = torch.tensor([True, True, False])
    with ops.kernel_policy(MODES[mode][0]):
        got, tc = TT.decode_step(tparams, ct, torch.from_numpy(tok).long(),
                                 tc, torch.from_numpy(pos).long(),
                                 active=active)
    assert_close(want, got, LOGITS_TOL, f"decode logits {mode}")
    for k in STATE:
        assert_close(jc["layers"][k][:, :2], tc["layers"][k][:, :2],
                     tol("f32"), f"decode state {k} {mode}")
        np.testing.assert_array_equal(tc["layers"][k][:, 2].numpy(),
                                      cache[k][:, 2])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_size_template_matches_jax(dtype):
    """mamba2-370m at full size, shapes only: the port's template equals
    JAX's leaf for leaf, with A_log / D / dt_bias f32 whatever the dtype
    and the 1.0 bpw ranks kernel #1 runs at on the card (wdt, 1024 -> 32,
    stays FP at the default min_dim of 48)."""
    cfg_t = dataclasses.replace(tconfigs.get_config(ARCH), dtype=dtype)
    cfg_j = dataclasses.replace(jconfigs.get_config(ARCH), dtype=dtype)
    flat_w, flat_g = flat_templates(
        jsurgery.abstract_quantized_params(cfg_j),
        tsurgery.abstract_quantized_params(cfg_t))
    assert flat_w == flat_g
    t = tsurgery.abstract_quantized_params(cfg_t)
    mixer = t["layers"]["mixer"]
    assert "lm_head" not in t                    # tied to the embedding
    for k in ("A_log", "D", "dt_bias"):
        assert mixer[k] == tsurgery.LeafSpec((48, 32), "float32")
    assert mixer["conv_x"] == tsurgery.LeafSpec((48, 4, 2048), dtype)
    assert mixer["conv_bB"] == tsurgery.LeafSpec((48, 128), dtype)
    assert mixer["wdt"] == {"w": tsurgery.LeafSpec((48, 1024, 32), dtype)}
    ranks = {k: mixer[k]["qv"].shape[-1] for k in PACKED}
    assert ranks == {"wz": 640, "wx": 640, "wB": 96, "wC": 96,
                     "out_proj": 640}
    assert mixer["wB"]["qu_t"].shape == (48, 3, 128)
    assert mixer["out_proj"]["qv"].shape == (48, 64, 640)


def test_merge_leaves_the_mixer_unmerged(model):
    """No merge group holds a mixer projection (JAX's ``MERGE_GROUPS`` has
    no mamba group): the merge returns the tree as JAX's does, and a
    forward launches #1 once per packed projection (5 per layer)."""
    cj, ct, _, jparams, tparams = model
    assert tsurgery.merge_projection_groups(tparams) is tparams
    jm = jax.tree_util.tree_flatten_with_path(
        jsurgery.merge_projection_groups(jparams))[0]
    tm = jax.tree_util.tree_flatten_with_path(tparams)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jm] == \
        [jax.tree_util.keystr(k) for k, _ in tm]
    calls = []
    real = ops.lowrank_binary_matmul

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    ops.lowrank_binary_matmul = spy
    try:
        with ops.kernel_policy(MODES["kernels"][0]):
            TT.forward(tparams, ct, torch.zeros((1, 3), dtype=torch.long))
    finally:
        ops.lowrank_binary_matmul = real
    assert len(calls) == len(PACKED) * ct.n_layers


def test_check_family_admits_ssm_only():
    """Of the state-space families, mamba2-370m (ssm) and, since the
    hybrid was ported, zamba2 (hybrid, over ring pages) are served; since
    the VLM was ported, llama-3.2-vision (vlm, over linear pages beside its
    per-slot image K/V) is served too, and since the audio family was
    ported, musicgen (audio, over linear pages of frames) as well. (The
    name predates the hybrid's port and is kept, so that the test keeps its
    identity across the changes.)"""
    check_family(tconfigs.get_config(ARCH))
    check_family(tconfigs.get_config("zamba2-1.2b"))
    assert paging.cache_page_kinds(tconfigs.get_smoke("zamba2-1.2b")) == \
        {"ring"}
    for arch in ("llama-3.2-vision-90b", "musicgen-medium"):
        check_family(tconfigs.get_config(arch))
        assert paging.cache_page_kinds(tconfigs.get_smoke(arch)) == \
            {"linear"}
    cfg = ModelConfig(**dataclasses.asdict(jconfigs.get_smoke(
        "musicgen-medium")))
    check_family(cfg)
    assert paging.cache_page_kinds(cfg) == {"linear"}
    assert paging.cache_page_kinds(tconfigs.get_smoke(ARCH)) == set()
    assert paging.cache_page_kinds(tconfigs.get_smoke("llama3.2-1b")) == \
        {"linear"}


# ---------------------------------------------------------------------------
# the state engine
# ---------------------------------------------------------------------------

# a 1-token prompt (the recurrent step), one past a chunk, and mid-flight
# admissions into reused slots (2 slots for 5 requests). No 2-token prompt:
# on a reused slot the reference's engine reads a stale ring row there
# (test_short_prompt_ring_is_right_aligned).
LENS, BUDGETS = [5, 1, 21, 1, 5], [6, 4, 5, 7, 3]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's engine runs, each made once and shared by the port's modes."""
    return {}


def _port_engine(ct, tparams, mode, **kw):
    return InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True,
                                                    **kw),
                           max_batch=2, max_len=48, device="cpu",
                           policy=MODES[mode][0])


@pytest.mark.parametrize("mode", list(MODES))
def test_state_engine_matches_jax_engine(model, jax_runs, mode):
    """The per-slot state engine (prefix cache requested, paged by
    default: neither builds anything for this family) against JAX's
    engine on the same trace: tokens, admission steps and decode steps
    identical; no pool, no index, KV bytes 0, the state cache's bytes
    those of 2 slots."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS)
    want, jstats, jsteps = jax_engine(jax_runs, cj, jparams, prompts,
                                      BUDGETS)
    teng = _port_engine(ct, tparams, mode)
    assert teng.paged is False and teng.kv is None and teng.prefix is None
    assert set(teng.cache["layers"]) == set(STATE)
    assert teng.kv_cache_bytes() == 0
    gn = ct.ssm_groups * ct.ssm_state
    assert teng.cache_bytes() == 4 * 3 * 2 * (
        ct.ssm_heads * ct.ssm_head_dim * ct.ssm_state
        + 3 * (ct.d_inner + 2 * gn))
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    assert teng.admission_step == jsteps
    assert teng.stats["decode_steps"] == jstats["decode_steps"]
    assert teng.stats["admissions"] == jstats["admissions"] == len(LENS)
    teng.check_invariants()
    assert not teng.active.any() and not teng.scheduler.pending


def test_engine_refusals_match_jax(model):
    """Speculation is refused in both packages, paged or not (no pool,
    then the recurrent state); a pool is never built for this family,
    and an attention family's ``paged=False`` builds the rectangle this
    family's state cache shares the engine's code with."""
    cj, ct, _, jparams, tparams = model
    for paged in (True, False):
        kw = dict(greedy=True, spec_rank_frac=0.5, paged=paged)
        with pytest.raises(ValueError, match="paged KV cache"):
            InferenceEngine(tparams, ct, ServeConfig(**kw), device="cpu")
        with pytest.raises(ValueError, match="paged KV cache"):
            JEngine(jparams, cj, JServeConfig(**kw))
    eng = InferenceEngine(tparams, ct, ServeConfig(paged=False), device="cpu")
    assert eng.kv is None and not eng.paged
    llama = f32(tconfigs.get_smoke("llama3.2-1b"))
    rect = InferenceEngine(torch_params(packed_model(llama, 0)), llama,
                           ServeConfig(paged=False), device="cpu")
    assert rect.kv is None and not rect.paged
    assert set(rect.cache["layers"]) == {"k", "v"}


def _greedy_forward(cj, jparams, prompt, n_new):
    """The greedy continuation of `prompt` by JAX's full-sequence
    ``T.forward``, one token at a time (one compile: the sequence is
    right-padded to its final length, and causality leaves the logits of
    the real tokens as they are)."""
    fwd = jax.jit(lambda p, t: JT.forward(p, cj, t)[0].argmax(-1))
    toks = np.zeros((1, len(prompt) + n_new), np.int32)
    toks[0, :len(prompt)] = prompt
    for i in range(len(prompt), toks.shape[1]):
        toks[0, i] = int(fwd(jparams, toks)[i - 1])
    return [int(t) for t in toks[0, len(prompt):]]


def test_short_prompt_ring_is_right_aligned(model):
    """A 2-token prompt (shorter than the conv's K-1 = 3 rows) gives the
    greedy continuation of JAX's ``T.forward`` on a fresh slot and on a
    slot a 6-token request used before: its ring is the 2 rows behind a
    zero row, whatever the slot held."""
    cj, ct, _, jparams, tparams = model
    want = _greedy_forward(cj, jparams, [1, 2], 4)
    outs = []
    for first in (None, draw_prompts(ct, [6], seed=4)[0]):
        eng = InferenceEngine(tparams, ct, ServeConfig(greedy=True),
                              max_batch=1, max_len=16, device="cpu")
        if first is not None:
            eng.submit(Request(0, first, max_new_tokens=3))
            eng.run()
        eng.submit(Request(1, np.array([1, 2], np.int64), max_new_tokens=4))
        outs.append(list(eng.run()[1].output))
    assert outs == [want, want]


# the reference's chaos run at its smoke size (benchmarks/serve_bench.py
# run_chaos) without speculation (refused for the family): 12 requests over
# 4 slots of max_len 48
CHAOS_SEED = 7 + 44
TERMINALS = ("cancelled", "expired", "failed", "device_faults")
KEYS = TERMINALS + ("decode_steps", "tokens_emitted", "admissions", "steps",
                    "preemptions")


def _trace(cfg):
    return chaos_trace(np.random.default_rng(CHAOS_SEED), 12, cfg.vocab_size)


@pytest.fixture(scope="module")
def jax_chaos(model):
    cj, _, _, jparams, _ = model
    trace = _trace(cj)
    plan = JFaultPlan([JFault(**dataclasses.asdict(f))
                       for f in chaos_plan(trace)], seed=CHAOS_SEED)
    eng = JEngine(jparams, cj, JServeConfig(greedy=True, debug=True),
                  max_batch=4, max_len=48, faults=plan)
    handles = drive_chaos(eng, trace, JRequest, plan)
    return (plan.fired, {u: h.status for u, h in handles.items()},
            {u: [int(t) for t in h.tokens] for u, h in handles.items()},
            {k: eng.stats[k] for k in KEYS})


@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_matches_jax(model, jax_chaos, mode):
    """The chaos plan on the state engine against JAX's: the fired log
    (the pool seams, the prefix eviction and the speculative cancel stay
    unfired on both), statuses, tokens and counters equal; the device
    error fails one slot and the others decode on in place (no
    preemption); every non-done handle carries a structured error."""
    _, ct, _, _, tparams = model
    trace = _trace(ct)
    plan = FaultPlan(chaos_plan(trace), seed=CHAOS_SEED)
    eng = InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True),
                          max_batch=4, max_len=48, device="cpu",
                          policy=MODES[mode][0], faults=plan)
    handles = drive_chaos(eng, trace, Request, plan)
    for h in handles.values():
        assert h.finished
        if h.status != "done":
            assert isinstance(h.error, RequestError) and h.error.reason
    fired = {k for _, k, _ in plan.fired}
    assert not fired & {"dry_pool", "preempt", "evict_prefix", "cancel_spec"}
    assert "device_error" in fired
    assert eng.stats["device_faults"] == 1 and eng.stats["preemptions"] == 0
    jfired, jstatuses, jtokens, jstats = jax_chaos
    assert plan.fired == jfired
    assert {u: h.status for u, h in handles.items()} == jstatuses
    assert {u: list(h.tokens) for u, h in handles.items()} == jtokens
    assert {k: eng.stats[k] for k in KEYS} == jstats


def test_drain_fails_live_slots(model):
    """Without a pool a live slot cannot be checkpointed: ``drain`` with
    no time left ends it "failed" with the reference's reason, a queued
    request stays queued, and admission stays closed."""
    _, ct, _, _, tparams = model
    eng = InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True),
                          max_batch=1, max_len=32, device="cpu")
    prompts = draw_prompts(ct, [4, 6], seed=2)
    h0 = eng.submit(Request(0, prompts[0], max_new_tokens=8))
    h1 = eng.submit(Request(1, prompts[1], max_new_tokens=8))
    eng.step()
    eng.drain(timeout=0)
    assert h0.status == "failed" and len(h0.tokens) == 2
    assert "cannot checkpoint a live slot" in h0.error.reason
    assert h1.status == "pending" and not eng.active.any()
    eng.step()
    assert h1.status == "pending"
    eng.resume_admission()
    eng.run()
    assert h1.done and len(h1.tokens) == 8


# ---------------------------------------------------------------------------
# artifacts, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifacts_cross_the_packages(tmp_path, dtype):
    """A JAX-saved mamba2 artifact (A_log / D / dt_bias f32 in a bf16
    model, the conv kernels cast like the other FP leaves) loads leaf for
    leaf in the port, and the port's ``save`` of it loads leaf for leaf in
    JAX."""
    cj, ct = (dataclasses.replace(c, dtype=dtype) for c in _configs())
    tree = packed_model(ct, seed=5, min_dim=MIN_DIM)
    jparams = jax_tree(tree)
    if dtype == "bfloat16":
        jparams = cast_jax(jparams, jnp.bfloat16)
    qcfg = japi.QuantConfig(target_bpw=1.0, min_dim=MIN_DIM)
    japi.NanoQuantModel(jparams, cj, qcfg, {"ranks": {}}).save(
        str(tmp_path / "jax"))
    m = NanoQuantModel.load(str(tmp_path / "jax"), device="cpu")
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(cj)
    leaves_equal(jparams, m.params)
    mixer = m.params["layers"]["mixer"]
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert mixer["conv_x"].dtype == mixer["norm_w"].dtype == want
    assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
    assert mixer["wB"]["s1"].dtype == torch.float32
    m.save(str(tmp_path / "port"))
    back = japi.NanoQuantModel.load(str(tmp_path / "port"))
    leaves_equal(jparams, back.params)


def test_serve_cli_serves_mamba(tmp_path):
    """``python -m repro_torch.launch.serve --arch mamba2-370m`` quantizes
    the smoke teacher on the CPU (the demo) and serves it on the state
    cache."""
    # the CLI quantizes its demo teacher first: one thread, as the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--requests", "3", "--prompt-len", "6",
         "--max-new", "4", "--max-batch", "2"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "mamba2-370m-smoke (bfloat16) teacher from seed 0" in out.stdout
    assert "[serve] quantized random-init teacher (demo)" in out.stdout
    assert "per-slot state cache of 2 slots" in out.stdout
    assert "3 requests, 12 tokens" in out.stdout
