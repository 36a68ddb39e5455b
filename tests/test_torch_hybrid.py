"""The port's hybrid family (zamba2: a Mamba2 stack plus one shared
attention block over a ring-paged sliding-window cache) against the JAX
reference, on zamba2-1.2b's smoke config (4 Mamba2 layers, d 64, d_inner
128, 8 heads of 16, state 16, conv 4, chunk 16; the shared block MHA 4 x
16, d_ff 128, after every 2nd layer, so 2 applications) packed with
``min_dim=8``, so that all six mixer projections pack (wdt 64 -> 8
included, as at full width, where it is 2048 -> 64) and so does the
shared block (rank 32).

Covered: the full-size template leaf for leaf (the unstacked
``shared_attn``, the packed wdt, the ranks #1 runs at on the card) and the
smoke template at ``min_dim`` 8 and 16; the merge (``wqkv`` / ``wgu`` in
the shared block only) and a forward's launches of #1; ``backbone`` /
``forward`` in f32 and bf16; the rectangular prefill (1, 2 and 21 tokens)
with its state and ring rows; the paged decode of three slots (one
inactive) before and after the ring wraps, against JAX's ``decode_step``
with a ring table; #2 and #3's plain versions and CPU wrappers at
``cache_pos = q_pos % rows`` with ``q_pos`` past the ring (the port of the
reference's ``tests/test_paging.py`` ring case), G = 1 and 2, with and
without a window, against JAX's oracles and Pallas kernels in interpret
mode, and the split walk's excluded row at an unwrapped ``cache_pos``; the
pool (``PagedKVState`` with ring pages in lockstep with JAX's; the mixed
cache's insert and select against JAX's); the engine's tokens against
JAX's paged and rectangular engines across ring wraps (window 16 on pages
of 8, the reference's ``test_hybrid_ring_wrap_in_paged_pool``, and window
20, a virtual ring of 24 rows longer than the window); no prefix index;
the refusals in the reference's order; a prompt longer than the ring
failing its request in both packages; the chaos plan against JAX's
engine; drain, snapshot and restore; artifacts both ways;
``launch.serve --arch zamba2-1.2b``.

Inputs come from ``np.random.default_rng``; tolerances are
``_torch_common.tol`` (relative max-abs f32 1e-5, bf16 3e-2) per layer
and 1e-4 for whole-model logits (``tests/test_torch_model.py``); f32
engine tokens are identical.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, cast_jax, check_forward,
                           draw_prompts, f32, flat_templates, jax_tree,
                           leaves_equal, packed, packed_model, pair,
                           same_tokens, serve_engine, tol, torch_params)
from repro import api as japi
from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.megakernel import decode_step_megakernel_raw as j_mega
from repro.kernels.paged_attention import paged_decode_attention as j_paged
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import paging as jpaging
from repro.serve import recovery as jrecovery
from repro.serve import scheduler as jscheduler
from repro.serve.faults import Fault as JFault
from repro.serve.faults import FaultPlan as JFaultPlan
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.kernels import megakernel, ops, paged_attention, ref
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import FaultPlan, RequestError, paging, recovery
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import (Request, cache_insert_slot,
                                         cache_select_active)
from repro_torch.testing import chaos_plan, chaos_trace, drive_chaos

ARCH = "zamba2-1.2b"
MIN_DIM = 8                  # packs the mixer's wdt (64 -> 8) and all else
LOGITS_TOL = 1e-4
MODES = {"ref": ops.KernelPolicy(mode="ref"),
         "kernels": ops.KernelPolicy(mode="cuda")}
MIXER = ("wz", "wx", "wB", "wC", "wdt", "out_proj")
STATE = ("ssm", "conv_x", "conv_B", "conv_C")
PS = 8                       # rows per page of the engine and pool tests
# (sliding window, rows of the virtual ring on pages of PS): the window
# the reference's own wrap test uses, and one whose ring is longer than it
WINDOWS = {16: 16, 20: 24}


def _configs(window=None):
    cj, ct = f32(jconfigs.get_smoke(ARCH)), f32(tconfigs.get_smoke(ARCH))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.family == "hybrid" and ct.attn_every == 2 \
        and TT.n_shared_apps(ct) == 2
    if window is not None:
        cj, ct = (dataclasses.replace(c, sliding_window=window)
                  for c in (cj, ct))
    return cj, ct


@pytest.fixture(scope="module")
def model():
    cj, ct = _configs()
    tree = packed_model(ct, seed=0, min_dim=MIN_DIM)
    return cj, ct, tree, jax_tree(tree), torch_params(tree)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's results, each computed once and shared by the port's modes."""
    return {}


# ---------------------------------------------------------------------------
# templates and the merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_size_template_matches_jax(dtype):
    """zamba2-1.2b at full size, shapes only: the port's template equals
    JAX's leaf for leaf, with the shared block unstacked and the ranks
    kernel #1 runs at on the card (1.0 bpw): the six mixer projections
    packed, wdt (2048 -> 64) included; every rank <= 4096, so the two-call
    chain (#4) is off the path."""
    cfg_t = dataclasses.replace(tconfigs.get_config(ARCH), dtype=dtype)
    cfg_j = dataclasses.replace(jconfigs.get_config(ARCH), dtype=dtype)
    flat_w, flat_g = flat_templates(
        jsurgery.abstract_quantized_params(cfg_j),
        tsurgery.abstract_quantized_params(cfg_t))
    assert flat_w == flat_g
    t = tsurgery.abstract_quantized_params(cfg_t)
    mixer, shared = t["layers"]["mixer"], t["shared_attn"]
    assert t["lm_head"]["w"] == tsurgery.LeafSpec((2048, 32000), dtype)
    ranks = {k: mixer[k]["qv"].shape[-1] for k in MIXER}
    assert ranks == {"wz": 1344, "wx": 1344, "out_proj": 1344, "wB": 32,
                     "wC": 32, "wdt": 32}
    assert mixer["wdt"]["qv"].shape == (38, 64, 32)
    assert mixer["wdt"]["qu_t"].shape == (38, 1, 64)
    assert shared["ln1"] == tsurgery.LeafSpec((2048,), dtype)
    assert {k: shared["attn"][k]["qv"].shape for k in ("wq", "wk", "wv",
                                                       "wo")} == \
        {"wq": (64, 992), "wk": (64, 992), "wv": (64, 992), "wo": (64, 992)}
    assert {k: v["qv"].shape[-1] for k, v in shared["ffn"].items()} == \
        {"w_gate": 1600, "w_up": 1600, "w_down": 1600}
    leaves = jax.tree_util.tree_leaves(
        t, is_leaf=lambda x: isinstance(x, tsurgery.LeafSpec))
    assert max(s.shape[-1] for s in leaves if s.dtype == "uint32") <= 8192


@pytest.mark.parametrize("min_dim,wdt_packed", [(8, True), (16, False)])
def test_smoke_template_matches_jax(min_dim, wdt_packed):
    """The smoke config: at ``min_dim`` 8 all six mixer projections and
    the shared block pack (rank 32); at 16 wdt (64 -> 8) stays FP, as JAX's
    selection rule decides."""
    cj, ct = _configs()
    w, g = flat_templates(jsurgery.abstract_quantized_params(cj, 1.0,
                                                             min_dim=min_dim),
                          tsurgery.abstract_quantized_params(ct, 1.0,
                                                             min_dim=min_dim))
    assert w == g
    t = tsurgery.abstract_quantized_params(ct, 1.0, min_dim=min_dim)
    assert ("qu_t" in t["layers"]["mixer"]["wdt"]) == wdt_packed
    assert t["shared_attn"]["attn"]["wq"]["qv"].shape == (2, 32)


def test_merge_adds_the_shared_groups_as_jax(model):
    """The merge adds ``wqkv`` and ``wgu`` to the unstacked shared block
    and nothing to the mixer, key for key as JAX's merge; a kernel-path
    forward (S = 3) launches #1 six times per layer and four times per
    application (merged QKV, wo, merged gate-up, w_down)."""
    cj, ct, _, jparams, tparams = model
    merged = tsurgery.merge_projection_groups(tparams)
    assert set(merged["shared_attn"]["attn"]) - set(
        tparams["shared_attn"]["attn"]) == {"wqkv"}
    assert set(merged["shared_attn"]["ffn"]) - set(
        tparams["shared_attn"]["ffn"]) == {"wgu"}
    assert merged["layers"] is tparams["layers"]
    jm = jax.tree_util.tree_flatten_with_path(
        jsurgery.merge_projection_groups(jparams))[0]
    tm = jax.tree_util.tree_flatten_with_path(merged)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jm] == \
        [jax.tree_util.keystr(k) for k, _ in tm]
    calls = []
    real = (ops.lowrank_binary_matmul, ops.lowrank_binary_matmul_merged)

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    ops.lowrank_binary_matmul, ops.lowrank_binary_matmul_merged = \
        map(spy, real)
    try:
        with ops.kernel_policy(MODES["kernels"]):
            TT.forward(merged, ct, torch.zeros((1, 3), dtype=torch.long))
    finally:
        ops.lowrank_binary_matmul, ops.lowrank_binary_matmul_merged = real
    apps = TT.n_shared_apps(ct)
    assert len(calls) == len(MIXER) * ct.n_layers + 4 * apps
    assert calls.count("lowrank_binary_matmul_merged") == 2 * apps


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_matches_jax(model):
    """The full-sequence forward in f32 (S = 11, the window of 64 covering
    it) on the kernel wrappers' dispatch."""
    cj, _, _, jparams, tparams = model
    check_forward(cj, jparams, tparams, MODES["kernels"], LOGITS_TOL,
                  f"{cj.name} f32")


def test_bf16_backbone_matches_jax_block_by_block(model):
    """The bf16 model (FP leaves cast, A_log / D / dt_bias kept f32) on the
    plain oracles, block by block: each Mamba2 block and each application
    of the shared block gets JAX's bf16 input and its output is held
    against JAX's at the bf16 tolerance; then the final norm and the head.
    (Whole-model bf16 logits drift by bf16 rounding in both packages over
    the 6 blocks: 3.7e-2 relative from the f32 forward in JAX's, 3.0e-2 in
    the port's, so the per-layer tolerance is applied per block.)"""
    cj, ct, tree, jparams, _ = model
    cjb, ctb = (dataclasses.replace(c, dtype="bfloat16") for c in (cj, ct))
    m = NanoQuantModel.from_numpy(tree, ctb, device="cpu",
                                  dtype=torch.bfloat16)
    tp = m.params
    jp = cast_jax(jparams, jnp.bfloat16)
    assert tp["shared_attn"]["ln1"].dtype == torch.bfloat16
    assert tp["layers"]["mixer"]["A_log"].dtype == torch.float32
    toks = draw_prompts(ct, [11], seed=1)[0][None]
    x = JT.embed_tokens(jp, cjb, toks)
    pos_j, pos_t = jnp.arange(11), torch.arange(11)
    jlayers = [jax.tree.map(lambda a, i=i: a[i], jp["layers"])
               for i in range(ct.n_layers)]
    mamba = jax.jit(lambda p, h: JT._apply_mamba_block(p, cjb, h)[0])
    shared = jax.jit(lambda p, h: JT._apply_attn_block(p, cjb, h, pos_j)[0])
    with ops.kernel_policy(MODES["ref"]):
        for i, (jl, tl) in enumerate(zip(jlayers,
                                         TT.split_layers(tp)["layers"])):
            want = mamba(jl, x)
            got, _ = TT._apply_mamba_block(tl, ctb, pair(
                np.asarray(x, np.float32), "bf16")[1])
            assert got.dtype == torch.bfloat16
            assert_close(want, got, tol("bf16"), f"bf16 mamba block {i}")
            x = want
            if TT.shared_app(ct, i) is not None:
                want = shared(jp["shared_attn"], x)
                got = TT._apply_attn_block(tp["shared_attn"], ctb, pair(
                    np.asarray(x, np.float32), "bf16")[1], pos_t)
                assert_close(want, got, tol("bf16"), f"bf16 shared {i}")
                x = want
        xt = pair(np.asarray(x, np.float32), "bf16")[1]
        want = JT.logits_fn(jp, cjb, JT.L.rms_norm(x, jp["ln_f"],
                                                   cjb.norm_eps))
        got = TT.logits_fn(tp, ctb, TT.L.rms_norm(xt, tp["ln_f"],
                                                  ctb.norm_eps))
    assert_close(want, got, tol("bf16"), "bf16 head")


def test_forward_applies_the_window():
    """Past the window the shared block masks the oldest keys: a forward
    at window 4 over 11 tokens equals JAX's and differs from the full
    causal forward."""
    cj, ct = _configs(window=4)
    tree = packed_model(ct, seed=1, min_dim=MIN_DIM)
    jparams, tparams = jax_tree(tree), torch_params(tree)
    check_forward(cj, jparams, tparams, MODES["kernels"], LOGITS_TOL,
                  "window 4")
    toks = torch.from_numpy(draw_prompts(ct, [11], seed=1)[0][None]).long()
    wide = dataclasses.replace(ct, sliding_window=0)
    assert not torch.allclose(TT.forward(tparams, ct, toks),
                              TT.forward(tparams, wide, toks))


@pytest.mark.parametrize("n", [1, 2, 21])
@pytest.mark.parametrize("mode", list(MODES))
def test_rect_prefill_matches_jax(model, jax_results, n, mode):
    """Logits, the terminal state and the ring rows of an exact-length
    prefill into a rectangular cache (max_len 24: a ring of 24 rows per
    application): 1 token takes the recurrent step, 2 leave a conv ring
    shorter than K-1 (right-aligned behind a zero row in the port,
    ROADMAP §3), 21 run the chunked SSD past one chunk. Rows [0, n) of
    each application's k / v hold the prompt's keys and values; the rest
    stay zero."""
    cj, ct, _, jparams, tparams = model
    toks = np.random.default_rng(n).integers(
        0, ct.vocab_size, size=(1, n)).astype(np.int32)
    if ("prefill", n) not in jax_results:
        jax_results["prefill", n] = jax.jit(lambda p, t: JT.prefill(
            p, cj, t, JT.init_cache(cj, 1, 24)))(jparams, toks)
    want, jcache = jax_results["prefill", n]
    with ops.kernel_policy(MODES[mode]):
        got, tcache = TT.prefill(tparams, ct, torch.from_numpy(toks).long(),
                                 TT.init_cache(ct, 1, 24, "cpu"))
    assert_close(want, got, LOGITS_TOL, f"prefill logits n={n} {mode}")
    assert set(tcache) == {"layers", "shared_attn"}
    st = tcache["layers"]
    for k in STATE:
        a, b = np.asarray(jcache["layers"][k]), st[k].numpy()
        if k != "ssm" and a.shape[2] < b.shape[2]:
            assert not b[:, :, :b.shape[2] - a.shape[2]].any()
            b = b[:, :, b.shape[2] - a.shape[2]:]
        assert_close(a, b, tol("f32"), f"prefill state {k} n={n} {mode}")
    assert int(jcache["window"]) == 24
    for leaf in ("k", "v"):
        t = tcache["shared_attn"][leaf]
        assert tuple(t.shape) == (2, 1, 24, ct.n_kv_heads, ct.head_dim)
        assert_close(jcache["shared_attn"][leaf], t, tol("f32"),
                     f"prefill ring {leaf} n={n} {mode}")
        assert not t[:, :, n:].any()


def _ring_tables(rows_per_slot, n_slots, inactive):
    """Whole rings of `rows_per_slot // PS` pages per slot, page ids in
    order from 1; the `inactive` slot's table all null."""
    pages = rows_per_slot // PS
    bt = np.arange(1, n_slots * pages + 1, dtype=np.int32).reshape(
        n_slots, pages)
    bt[inactive] = 0
    return bt


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("mode", list(MODES))
def test_paged_decode_matches_jax(model, jax_results, window, mode):
    """One paged decode step of three slots over the ring pool, from a
    random state and random pages: slot 0 before its ring wraps (pos 5),
    slot 1 past it (pos 30 of a ring of 16 or 24 rows: the write lands on
    row 30 mod rows, the window masks the rest), slot 2 inactive (all-null
    table). Logits, the active slots' state and the mapped pages equal
    JAX's ``decode_step`` with ``block_tables={"ring": ...}``; the inactive
    slot's state stays bit for bit."""
    cj, ct = _configs(window)
    _, _, _, jparams, tparams = model
    rows = WINDOWS[window]
    bt = _ring_tables(rows, 3, inactive=2)
    rng = np.random.default_rng(window)
    state = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in TT.state_cache(ct, 3, "cpu").items()}
    n_pages = int(bt.max()) + 1
    pool = {leaf: rng.standard_normal((2, n_pages, PS, ct.n_kv_heads,
                                       ct.head_dim)).astype(np.float32)
            for leaf in ("k", "v")}
    tok = rng.integers(0, ct.vocab_size, size=(3, 1)).astype(np.int32)
    pos = np.array([5, 30, 7], np.int32)
    key = ("decode", window)
    if key not in jax_results:
        jcache = {"layers": {k: jnp.asarray(v) for k, v in state.items()},
                  "shared_attn": {k: jnp.asarray(v) for k, v in pool.items()},
                  "window": window}
        jax_results[key] = jax.jit(lambda p, t, c, q, b: JT.decode_step(
            p, cj, t, c, q, block_tables={"ring": b}))(
                jparams, tok, jcache, pos, bt)
    want, jc = jax_results[key]
    tc = {"layers": {k: torch.from_numpy(v.copy()) for k, v in state.items()},
          "shared_attn": {k: torch.from_numpy(v.copy())
                          for k, v in pool.items()}}
    active = torch.tensor([True, True, False])
    with ops.kernel_policy(MODES[mode]):
        got, tc = TT.decode_step(
            tparams, ct, torch.from_numpy(tok).long(), tc,
            torch.from_numpy(pos).long(),
            block_tables={"ring": torch.from_numpy(bt)}, active=active)
    assert_close(want[:2], got[:2], LOGITS_TOL, f"decode logits {mode}")
    for k in STATE:
        assert_close(jc["layers"][k][:, :2], tc["layers"][k][:, :2],
                     tol("f32"), f"decode state {k} {mode}")
        np.testing.assert_array_equal(tc["layers"][k][:, 2].numpy(),
                                      state[k][:, 2])
    for leaf in ("k", "v"):
        # page 0 is the inactive slot's trash
        assert_close(jc["shared_attn"][leaf][:, 1:],
                     tc["shared_attn"][leaf][:, 1:], tol("f32"),
                     f"decode ring pool {leaf} {mode}")
    # slot 1's fresh row landed on row 30 mod rows of its ring
    r = 30 % rows
    page = bt[1, r // PS]
    assert not np.array_equal(tc["shared_attn"]["k"][:, page, r % PS].numpy(),
                              pool["k"][:, page, r % PS])


def test_hybrid_decode_needs_its_ring_table(model, jax_results):
    """Without a ring table the hybrid decodes over its rectangular ring of
    ``win`` rows, as the reference does: 3 slots at positions 4, 13 and
    37 of a ring of 16 rows (the last has wrapped it twice; every row and
    the state filled with noise) against JAX's ``decode_step`` on
    ``init_cache``'s layout, the write at row ``pos % win``, logits within
    1e-5 relative; an inactive slot keeps its state. A prompt longer than
    the ring is refused."""
    cj, ct = _configs(window=16)
    _, _, _, jparams, tparams = model
    rng = np.random.default_rng(3)
    state = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in TT.state_cache(ct, 3, "cpu").items()}
    ring = {leaf: rng.standard_normal((2, 3, 16, ct.n_kv_heads,
                                       ct.head_dim)).astype(np.float32)
            for leaf in ("k", "v")}
    tok = rng.integers(0, ct.vocab_size, size=(3, 1)).astype(np.int32)
    pos = np.array([4, 13, 37], np.int32)
    if "rect-decode" not in jax_results:
        jcache = {"layers": {k: jnp.asarray(v) for k, v in state.items()},
                  "shared_attn": {k: jnp.asarray(v) for k, v in ring.items()},
                  "window": 16}
        jax_results["rect-decode"] = jax.jit(
            lambda p, t, c, q: JT.decode_step(p, cj, t, c, q))(
                jparams, tok, jcache, pos)
    want, jc = jax_results["rect-decode"]
    for mode, pol in MODES.items():
        tc = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in state.items()},
              "shared_attn": {k: torch.from_numpy(v.copy())
                              for k, v in ring.items()}}
        with ops.kernel_policy(pol):
            got, tc = TT.decode_step(
                tparams, ct, torch.from_numpy(tok).long(), tc,
                torch.from_numpy(pos).long(),
                active=torch.tensor([True, True, False]))
        assert_close(want[:2], got[:2], 1e-5, f"rect decode logits {mode}")
        for leaf in ("k", "v"):
            assert_close(jc["shared_attn"][leaf], tc["shared_attn"][leaf],
                         1e-5, f"rect ring {leaf} {mode}")
        for k in STATE:
            np.testing.assert_array_equal(tc["layers"][k][:, 2].numpy(),
                                          state[k][:, 2])
    cache = TT.init_cache(ct, 1, 8, "cpu")
    with pytest.raises(ValueError, match="longer than the shared attention"):
        TT.prefill(tparams, ct, torch.zeros((1, 9), dtype=torch.long), cache)


# ---------------------------------------------------------------------------
# kernels #2 and #3 at a wrapped ring (cache_pos != q_pos)
# ---------------------------------------------------------------------------


def _ring_case(rng, B, hq, hkv, D, pages, dt):
    """Whole ring tables (every entry mapped, in a shuffled order), the
    last slot all-null; q_pos past the ring's rows (up to three wraps) and
    cache_pos = q_pos % rows, the hybrid's paged decode."""
    n_pages = B * pages + 1
    kp = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, hq, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        B, pages)
    bt[-1] = 0
    rows = pages * PS
    q_pos = rng.integers(rows, 4 * rows, size=B).astype(np.int32)
    return (pair(q, dt), pair(kp, dt), pair(vp, dt), pair(bt), pair(q_pos),
            pair(q_pos % rows))


RING_CASES = [  # dt, B, hq, hkv, D, pages, window
    ("f32", 3, 4, 4, 16, 3, 0), ("f32", 3, 4, 4, 16, 3, 20),
    ("f32", 4, 8, 4, 16, 2, 10), ("bf16", 3, 4, 4, 16, 4, 0),
    ("bf16", 2, 2, 1, 32, 3, 24)]


@pytest.mark.parametrize("dt,B,hq,hkv,D,pages,window", RING_CASES)
def test_paged_attention_at_a_wrapped_ring(dt, B, hq, hkv, D, pages,
                                           window):
    """#2's plain version, CPU wrapper, S-loop dispatch and split-walk model
    against JAX's oracle at ``cache_pos = q_pos % rows`` (the reference's
    ring case), G = 1 (zamba2's MHA) and G = 2, with and without a window
    (20 and 24: wider than the ring; 10: narrower)."""
    case = _ring_case(np.random.default_rng(B * pages + window), B, hq, hkv,
                      D, pages, dt)
    jargs, targs = [c[0] for c in case], [c[1] for c in case]
    scale = 1.0 / math.sqrt(D)
    want = jax.jit(lambda *a: jref.paged_attention_ref(
        *a, window=window, scale=scale))(*jargs)
    got = ref.paged_attention_ref(*targs, window=window, scale=scale)
    assert_close(want, got, tol(dt), "ring oracle")
    got = paged_attention.paged_decode_attention(*targs, window=window,
                                                 scale=scale)
    assert_close(want, got, tol(dt), "ring wrapper (cpu)")
    got = ops.paged_attention(*targs, window=window, scale=scale,
                              policy=ops.KernelPolicy(mode="cuda"))
    assert_close(want, got, tol(dt), "ring S-loop (cpu)")
    q = targs[0][:, 0].float()
    m, l, acc = paged_attention.split_walk_model(
        q, targs[1].float(), targs[2].float(), *targs[3:], window=window,
        scale=scale, splits=2)
    o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    assert_close(np.asarray(want, np.float32)[:-1],
                 o.reshape(B, 1, hq, D)[:-1], tol(dt), "ring split walk")


def test_ring_kernels_match_pallas_interpret():
    """The CPU wrappers of #2 and #3 against JAX's Pallas kernels in
    interpret mode, at a wrapped ring with G = 1 and a window. #3 is held
    on the slots that map pages: the last slot's all-null table maps the
    null page three times, so the oracle's fresh row lands in all three
    copies while the Pallas kernel folds it in once (JAX's two differ
    there too, and no engine reads an inactive slot's output)."""
    rng = np.random.default_rng(41)
    case = _ring_case(rng, 3, 4, 4, 16, 3, "f32")
    jargs, targs = [c[0] for c in case], [c[1] for c in case]
    want = j_paged(*jargs, window=20, scale=0.25, interpret=True)
    got = paged_attention.paged_decode_attention(*targs, window=20,
                                                 scale=0.25)
    assert_close(want, got, tol("f32"), "ring paged vs pallas")
    mcase = _mega_ring_case(rng, "f32", case)
    kw = dict(head_dim=16, dims=(64, 64), theta=10000.0, scale=0.25,
              window=20)
    want = j_mega(*mcase[0], bk=32, bn=32, interpret=True, **kw)
    got = megakernel.decode_step_megakernel_raw(*mcase[1], **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        assert_close(a[:-1], b[:-1], tol("f32"),
                     f"ring megakernel vs pallas {nm}")


def _mega_ring_case(rng, dt, case, K=64, R=32):
    """Merged-QKV and wo operands for #3 over `case`'s ring (G = hq/hkv);
    returns (JAX args, port args)."""
    hq, hkv, D = case[0][1].shape[2], case[1][1].shape[2], case[0][1].shape[3]
    nq, nkv = hq * D, hkv * D
    nmax = max(nq, nkv)
    s1 = rng.standard_normal((3, nmax)).astype(np.float32) / np.sqrt(R)
    for i, n in enumerate((nq, nkv, nkv)):
        s1[i, n:] = 0.0
    mqkv = {"qv": rng.integers(0, 2 ** 32, (3, K // 32, R), dtype=np.uint32),
            "qu_t": rng.integers(0, 2 ** 32, (3, R // 32, nmax),
                                 dtype=np.uint32),
            "s1": s1, "rmask": np.ones((3, R), np.float32),
            "s2": rng.standard_normal((3, K)).astype(np.float32) / np.sqrt(K)}
    wo = {"qv": packed(rng, nq, 32), "qu_t": packed(rng, 32, K),
          "s1": rng.standard_normal(K).astype(np.float32) / 8.0,
          "s2": rng.standard_normal(nq).astype(np.float32) / np.sqrt(nq)}
    x = pair(rng.standard_normal((case[0][1].shape[0], K)
                                 ).astype(np.float32), dt)
    mq = {k: pair(v) for k, v in mqkv.items()}
    wp = {k: pair(v) for k, v in wo.items()}
    return tuple((x[s], {k: v[s] for k, v in mq.items()},
                  {k: v[s] for k, v in wp.items()}, case[1][s], case[2][s],
                  case[3][s], case[4][s], case[5][s]) for s in (0, 1))


@pytest.mark.parametrize("dt,B,hq,hkv,D,pages,window", RING_CASES)
def test_megakernel_at_a_wrapped_ring(dt, B, hq, hkv, D, pages, window):
    """#3's plain version and CPU wrapper against JAX's oracle at a wrapped
    ring: the fresh row lands on ``q_pos % rows`` and the window (when
    set) masks the rows the ring still holds past it."""
    rng = np.random.default_rng(100 + B * pages + window)
    case = _ring_case(rng, B, hq, hkv, D, pages, dt)
    jargs, targs = _mega_ring_case(rng, dt, case)
    kw = dict(head_dim=D, dims=(hq * D, hkv * D), theta=10000.0,
              scale=1.0 / math.sqrt(D), window=window)
    want = jax.jit(lambda *a: jref.decode_step_ref(*a, **kw))(*jargs)
    got = megakernel.decode_step_megakernel_raw(*targs, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        assert_close(a[:-1], b[:-1], tol(dt), f"ring megakernel {nm}")


def test_split_walk_excludes_the_written_row_modulo_rows():
    """The megakernel's walk leaves out the row this token writes,
    ``cache_pos mod rows``: at an unwrapped cache_pos (past the ring's
    rows) it reads what the wrapped one reads, and the fold of the fresh
    entry then gives JAX's oracle, which writes at ``cache_pos % rows``."""
    rng = np.random.default_rng(3)
    case = _ring_case(rng, 3, 4, 4, 16, 3, "f32")
    q, kp, vp, bt, qp, cp = [c[1] for c in case]
    rows = bt.shape[1] * PS
    unwrapped = cp + rows * torch.tensor([1, 2, 3], dtype=cp.dtype)
    kw = dict(window=20, scale=0.25, splits=2, exclude_cache_row=True)
    a = paged_attention.split_walk_model(q[:, 0], kp, vp, bt, qp, cp, **kw)
    b = paged_attention.split_walk_model(q[:, 0], kp, vp, bt, qp, unwrapped,
                                         **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    jargs, targs = _mega_ring_case(rng, "f32", case)
    kw = dict(head_dim=16, dims=(64, 64), theta=10000.0, scale=0.25,
              window=20)
    want = jax.jit(lambda *a: jref.decode_step_ref(*a, **kw))(*jargs)
    got = megakernel.decode_step_megakernel_raw(*targs[:7], unwrapped, **kw)
    for nm, u, v in zip(("y", "k_new", "v_new"), want, got):
        assert_close(u, v, tol("f32"), f"unwrapped cache_pos {nm}")


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_ring_pool_in_lockstep_with_jax():
    """``PagedKVState`` with ring pages against JAX's, driven together:
    admissions map a whole ring (3 pages for a window of 20 on pages of
    8), a full pool refuses, releases and borrows give JAX's page ids,
    nothing maps or trims linear rows, and the audits pass; a ring table
    mapping a page its slot does not own fails the audit."""
    cj, _ = _configs(window=20)
    j = jpaging.PagedKVState(cj, 3, 48, PS, 8, kinds={"ring"})
    t = paging.PagedKVState(3, 48, PS, 8, kinds={"ring"}, window=20)
    assert (t.has_ring, t.has_linear, t.ring_pages, t.lin_pages) == \
        (j.has_ring, j.has_linear, j.ring_pages, j.lin_pages) == \
        (True, False, 3, 0)
    assert set(t.tables) == set(j.tables) == {"ring"}

    def same():
        np.testing.assert_array_equal(j.tables["ring"], t.tables["ring"])
        np.testing.assert_array_equal(j.ref, t.ref)
        assert j._free == t._free and j.used_pages == t.used_pages
        assert [sorted(p) for p in j._slot_pages] == \
            [sorted(p) for p in t._slot_pages]
        j.check_invariants()
        t.check_invariants()

    for slot, n in ((0, 5), (1, 19)):
        assert t.pages_for_prompt(n) == j.pages_for_prompt(n) == 3
        want, got = j.admit(slot, n), t.admit(slot, n)
        assert want.keys() == got.keys() == {"ring"}
        np.testing.assert_array_equal(want["ring"], got["ring"])
        same()
    assert t.free_pages == j.free_pages == 1
    assert t.reserve_rows(0, 40) and t.ensure(1, 30)
    assert t.trim(0, 1) == j.trim(0, 1) == 0
    assert t.next_shared_write_page(0, 0, 20) is None
    with pytest.raises(ValueError, match="linear"):
        t.admit(2, 4, shared=[1])
    t.release(0)
    j.release(0)
    same()
    assert t.borrow_pages(2) == j.borrow_pages(2)
    same()
    assert t.borrow_pages(5) == j.borrow_pages(5)       # what is left
    t.return_pages(sorted(t.external))
    j.return_pages(sorted(j.external))
    same()
    want, got = j.admit(2, 7), t.admit(2, 7)
    np.testing.assert_array_equal(want["ring"], got["ring"])
    same()
    t.tables["ring"][2, 0] = t.tables["ring"][1, 0]
    with pytest.raises(paging.PageAccountingError, match="does not own"):
        t.check_invariants()
    with pytest.raises(ValueError, match="worst case"):
        paging.PagedKVState(3, 48, PS, 3, kinds={"ring"}, window=20)


def test_mixed_cache_insert_and_select_match_jax(model):
    """The hybrid's pool cache: the ring pool ``(n_apps, n_pages, PS, Hkv,
    D)`` beside the slot-indexed state, as JAX's ``init_paged_cache``
    lays it out; ``paged_insert_slot`` scatters a prefilled rectangle's
    ring rows into the slot's ring pages (rows past the window zero) and
    its state into the slot; ``paged_select_active`` selects state only
    and leaves the pool alone. On the rectangle the scheduler's
    ``cache_insert_slot`` / ``cache_select_active`` cover the ring too,
    as JAX's do."""
    cj, ct = _configs(window=20)
    _, _, _, jparams, tparams = model
    jpool = jpaging.init_paged_cache(cj, 2, 48, n_pages=7, page_size=PS)
    tpool = paging.init_paged_cache(ct, 7, PS, "cpu", batch=2)
    assert {k: jpool[k] for k in ("layers", "shared_attn")}.keys() == \
        tpool.keys()
    for stack in tpool:
        for leaf, t in tpool[stack].items():
            assert tuple(t.shape) == tuple(jpool[stack][leaf].shape), leaf
    assert paging.kv_cache_bytes(tpool) == jpaging.kv_cache_bytes(jpool)
    toks = draw_prompts(ct, [13], seed=9)[0][None]
    _, jsingle = jax.jit(lambda p, t: JT.prefill(
        p, cj, t, JT.init_cache(cj, 1, 48)))(jparams, toks)
    _, tsingle = TT.prefill(tparams, ct, torch.from_numpy(toks).long(),
                            TT.init_cache(ct, 1, 48, "cpu"))
    ids = np.array([4, 2, 6], np.int32)
    jpool = jpaging.paged_insert_slot(jpool, jsingle, 1,
                                      {"ring": jnp.asarray(ids)})
    paging.paged_insert_slot(tpool, tsingle, {"ring": torch.from_numpy(ids)},
                             slot=1)
    for stack in tpool:
        for leaf, t in tpool[stack].items():
            assert_close(jpool[stack][leaf], t, tol("f32"),
                         f"insert {stack}/{leaf}")
    assert not tpool["shared_attn"]["k"][:, ids[2], 4:].any()
    with pytest.raises(ValueError, match="slot"):
        paging.paged_insert_slot(tpool, tsingle,
                                 {"ring": torch.from_numpy(ids)})
    new = {s: {k: v + 1 for k, v in leaves.items()}
           for s, leaves in tpool.items()}
    active = torch.tensor([False, True])
    jactive = jnp.asarray([False, True])
    jnew = jax.tree.map(lambda a: jnp.asarray(a.numpy()), new)
    want = jpaging.paged_select_active(
        dict(jnew, window=20), dict(jpool), jactive)
    sel = paging.paged_select_active(new, tpool, active)
    for stack in tpool:
        for leaf, t in sel[stack].items():
            np.testing.assert_array_equal(np.asarray(want[stack][leaf]),
                                          t.numpy())
    jrect = jscheduler.cache_insert_slot(JT.init_cache(cj, 2, 48), jsingle, 1)
    trect = cache_insert_slot(TT.init_cache(ct, 2, 48, "cpu"), tsingle, 1)
    rnew = {s: {k: v + 1 for k, v in leaves.items()}
            for s, leaves in trect.items()}
    def as_jax(tree):
        return dict(jax.tree.map(lambda a: jnp.asarray(a.numpy()), tree),
                    window=20)
    want = jscheduler.cache_select_active(as_jax(rnew), as_jax(trect),
                                          jactive)
    got = cache_select_active(rnew, trect, active)
    assert set(got) == set(trect) == {"layers", "shared_attn"}
    for stack in trect:
        for leaf, t in trect[stack].items():
            assert_close(jrect[stack][leaf], t, tol("f32"),
                         f"rect insert {stack}/{leaf}")
            np.testing.assert_array_equal(np.asarray(want[stack][leaf]),
                                          got[stack][leaf].numpy())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# mid-flight admissions into reused slots (2 slots for 4 requests), a
# one-token prompt (the recurrent step and a one-row ring) and budgets that
# carry every slot's writes past its ring
LENS, BUDGETS = [5, 7, 1, 12], [26, 20, 30, 9]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's engine runs, each made once and shared by the port's modes."""
    return {}


def _jax_run(runs, window, paged, jparams, **kw):
    key = (window, paged, tuple(sorted(kw.items())))
    if key not in runs:
        cj, ct = _configs(window)
        eng = JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS,
                                                paged=paged, **kw),
                      max_batch=2, max_len=48)
        prompts = draw_prompts(ct, LENS, seed=4)
        runs[key] = (serve_engine(eng, JRequest, prompts, BUDGETS),
                     dict(eng.stats), dict(eng.admission_step))
    return runs[key]


def _port_engine(ct, tparams, mode, **kw):
    return InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True,
                                                    page_size=PS, **kw),
                           max_batch=2, max_len=48, device="cpu",
                           policy=MODES[mode])


def _drained(eng):
    assert not eng.kv.ref.any() and eng.kv.used_pages == 0
    assert not eng.kv.tables["ring"].any()
    assert not eng.active.any() and not eng.scheduler.pending
    eng.check_invariants()


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("mode", list(MODES))
def test_ring_wrap_engine_matches_jax(model, jax_runs, window, mode):
    """The engine over the ring pool (the reference's
    ``test_hybrid_ring_wrap_in_paged_pool``): greedy tokens identical to
    JAX's paged engine and to its rectangular engine (``paged=False``,
    writes at ``pos % window``) while three of the four requests' writes
    wrap their ring; admission and decode steps equal JAX's; one pool of
    ring pages (no linear table, no prefix index) beside the per-slot
    state; the pool drained. The port's rectangular engine, whose rings
    of ``window`` rows wrap at other rows than the pool's, gives JAX's
    tokens too."""
    cj, ct = _configs(window)
    _, _, _, jparams, tparams = model
    want, jstats, jsteps = _jax_run(jax_runs, window, True, jparams)
    rect, _, _ = _jax_run(jax_runs, window, False, jparams)
    same_tokens(want, rect)
    eng = _port_engine(ct, tparams, mode)
    assert eng.paged and eng.kv.has_ring and not eng.kv.has_linear
    assert eng.kv.ring_pages * PS == WINDOWS[window]
    assert eng.prefix is None and set(eng.kv.tables) == {"ring"}
    # the last write of a request lands at position n + b - 2
    last = [n + b - 2 for n, b in zip(LENS, BUDGETS)]
    assert sum(p >= WINDOWS[window] for p in last) >= 3
    got = serve_engine(eng, Request, draw_prompts(ct, LENS, seed=4), BUDGETS)
    same_tokens(want, got)
    assert eng.admission_step == jsteps
    assert eng.stats["decode_steps"] == jstats["decode_steps"]
    assert eng.kv.peak_used_pages == 2 * eng.kv.ring_pages
    _drained(eng)
    reng = _port_engine(ct, tparams, mode, paged=False)
    assert reng.kv is None
    assert tuple(reng.cache["shared_attn"]["k"].shape[1:3]) == (2, window)
    same_tokens(rect, serve_engine(reng, Request, draw_prompts(
        ct, LENS, seed=4), BUDGETS))
    assert reng.admission_step == jsteps
    assert reng.kv_cache_bytes() == 2 * 2 * window * 2 * ct.n_kv_heads \
        * ct.head_dim * 4


def test_engine_cache_bytes(model):
    """The engine's cache holds the ring pool and the state of every
    slot: ``kv_cache_bytes`` counts the pool, ``cache_bytes`` both, the
    pool's rows per slot cost n_apps x 2 x Hkv x D x 4 bytes in f32."""
    _, ct, _, _, tparams = model
    eng = _port_engine(ct, tparams, "ref")
    kv = eng.kv
    assert set(eng.cache) == {"layers", "shared_attn"}
    per_row = 2 * 2 * ct.n_kv_heads * ct.head_dim * 4
    assert eng.kv_cache_bytes() == per_row * kv.n_pages * kv.page_size
    state = sum(t.numel() * t.element_size()
                for t in eng.cache["layers"].values())
    assert eng.cache_bytes() == eng.kv_cache_bytes() + state
    gn = ct.ssm_groups * ct.ssm_state
    assert state == 4 * ct.n_layers * 2 * (
        ct.ssm_heads * ct.ssm_head_dim * ct.ssm_state
        + 3 * (ct.d_inner + 2 * gn))


def test_prefix_cache_builds_no_index(model):
    """``prefix_cache=True`` (the default) builds no index over ring
    tables, in either package."""
    cj, ct, _, jparams, tparams = model
    j = JEngine(jparams, cj, JServeConfig(prefix_cache=True), max_batch=2,
                max_len=32)
    t = InferenceEngine(tparams, ct, ServeConfig(prefix_cache=True),
                        max_batch=2, max_len=32, device="cpu")
    assert j.prefix is None and t.prefix is None
    assert set(j.kv.tables) == set(t.kv.tables) == {"ring"}


def test_refusals_match_jax(model):
    """Speculation is refused at "linear page tables only" in both
    packages, before the recurrent-state check (the reference's order);
    without a pool the paged-cache check comes first in both. Without
    speculation ``paged=False`` builds the rectangle: no pool, a ring of
    ``min(max_len, window)`` rows per slot beside the state."""
    cj, ct, _, jparams, tparams = model
    kw = dict(greedy=True, spec_rank_frac=0.5)
    with pytest.raises(ValueError, match="linear page tables only"):
        InferenceEngine(tparams, ct, ServeConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="linear page tables only"):
        JEngine(jparams, cj, JServeConfig(**kw))
    with pytest.raises(ValueError, match="paged KV cache"):
        InferenceEngine(tparams, ct, ServeConfig(paged=False, **kw),
                        device="cpu")
    with pytest.raises(ValueError, match="paged KV cache"):
        JEngine(jparams, cj, JServeConfig(paged=False, **kw))
    eng = InferenceEngine(tparams, ct, ServeConfig(paged=False),
                          max_batch=2, max_len=32, device="cpu")
    assert eng.kv is None and eng.prefix is None and eng.spec is None
    assert set(eng.cache) == {"layers", "shared_attn"}
    assert tuple(eng.cache["shared_attn"]["k"].shape[:3]) == (
        TT.n_shared_apps(ct), 2, min(32, ct.sliding_window or 32))


@pytest.fixture(scope="module")
def jax_overlong(model):
    cj, ct = _configs(window=16)
    _, _, _, jparams, _ = model
    eng = JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS),
                  max_batch=2, max_len=48)
    prompts = draw_prompts(ct, [10, 24], seed=6)
    hs = [eng.submit(JRequest(u, p, max_new_tokens=6))
          for u, p in enumerate(prompts)]
    eng.run()
    return ([h.status for h in hs], [list(map(int, h.tokens)) for h in hs],
            eng.stats["failed"], hs[1].error.reason)


@pytest.mark.parametrize("mode", list(MODES))
def test_prompt_longer_than_the_ring_fails(model, jax_overlong, mode):
    """A 24-token prompt at a window of 16 (max_len 48) ends "failed" in
    both packages (the prefill cannot write 24 rows into a ring of 16),
    with no pages leaked; the 10-token request beside it finishes with
    JAX's tokens."""
    _, ct = _configs(window=16)
    tparams = model[4]
    statuses, tokens, n_failed, jreason = jax_overlong
    assert statuses == ["done", "failed"] and n_failed == 1
    assert "24" in jreason
    eng = _port_engine(ct, tparams, mode)
    prompts = draw_prompts(ct, [10, 24], seed=6)
    hs = [eng.submit(Request(u, p, max_new_tokens=6))
          for u, p in enumerate(prompts)]
    eng.run()
    assert [h.status for h in hs] == statuses
    assert [list(h.tokens) for h in hs] == tokens
    assert eng.stats["failed"] == 1
    assert isinstance(hs[1].error, RequestError)
    assert "longer than the shared attention's ring of 16 rows" in \
        hs[1].error.reason
    _drained(eng)


# the reference's chaos run at its smoke size (benchmarks/serve_bench.py
# run_chaos) without speculation (refused for ring tables): 12 requests over
# 4 slots of max_len 48 (a ring of 48 rows: the smoke window is 64), on
# pages of 8, so that the pool's seams (dry pool, preemption) fire
CHAOS_SEED = 7 + 44
TERMINALS = ("cancelled", "expired", "failed", "device_faults")
KEYS = TERMINALS + ("decode_steps", "tokens_emitted", "admissions", "steps",
                    "preemptions", "page_waits")


def _trace(cfg):
    return chaos_trace(np.random.default_rng(CHAOS_SEED), 12, cfg.vocab_size)


@pytest.fixture(scope="module")
def jax_chaos(model):
    cj, _, _, jparams, _ = model
    trace = _trace(cj)
    plan = JFaultPlan([JFault(**dataclasses.asdict(f))
                       for f in chaos_plan(trace)], seed=CHAOS_SEED)
    eng = JEngine(jparams, cj, JServeConfig(greedy=True, debug=True,
                                            page_size=PS),
                  max_batch=4, max_len=48, faults=plan)
    handles = drive_chaos(eng, trace, JRequest, plan)
    return (plan.fired, {u: h.status for u, h in handles.items()},
            {u: [int(t) for t in h.tokens] for u, h in handles.items()},
            {k: eng.stats[k] for k in KEYS})


@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_matches_jax(model, jax_chaos, mode):
    """The chaos plan on the hybrid engine against JAX's: the fired log
    (the dry-pool borrow and the preemption storm fire on the ring pool;
    the prefix eviction and the speculative cancel stay unfired on both),
    statuses, tokens and counters equal; every non-done handle carries a
    structured error and the pool drains."""
    _, ct, _, _, tparams = model
    trace = _trace(ct)
    plan = FaultPlan(chaos_plan(trace), seed=CHAOS_SEED)
    eng = InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True,
                                                   page_size=PS),
                          max_batch=4, max_len=48, device="cpu",
                          policy=MODES[mode], faults=plan)
    handles = drive_chaos(eng, trace, Request, plan)
    for h in handles.values():
        assert h.finished
        if h.status != "done":
            assert isinstance(h.error, RequestError) and h.error.reason
    fired = {k for _, k, _ in plan.fired}
    assert {"dry_pool", "preempt", "device_error"} <= fired
    assert not fired & {"evict_prefix", "cancel_spec"}
    assert eng.stats["preemptions"] > 0
    jfired, jstatuses, jtokens, jstats = jax_chaos
    assert plan.fired == jfired
    assert {u: h.status for u, h in handles.items()} == jstatuses
    assert {u: list(h.tokens) for u, h in handles.items()} == jtokens
    assert {k: eng.stats[k] for k in KEYS} == jstats
    _drained(eng)


DRAIN_LENS = [6, 9, 4]


@pytest.fixture(scope="module")
def undisturbed(model):
    """The port's engine on the drain test's requests, undisturbed."""
    _, ct, _, _, tparams = model
    return serve_engine(_port_engine(ct, tparams, "ref"), Request,
                        draw_prompts(ct, DRAIN_LENS, seed=8), [8, 8, 8],
                        midflight=False)


@pytest.mark.parametrize("dest", ["port", "jax"])
def test_drain_snapshot_restore(model, undisturbed, tmp_path, dest):
    """``drain(timeout=0)`` preempts the live slots (the hybrid has a
    pool), releasing their ring pages; the snapshot restores into a fresh
    engine of either package, and every request ends with the undisturbed
    engine's tokens (the resume re-prefills prompt plus emitted tokens)."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, DRAIN_LENS, seed=8)
    want = undisturbed
    eng = _port_engine(ct, tparams, "ref")
    for u, p in enumerate(prompts):
        eng.submit(Request(u, p, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    before = dict(eng.drain(timeout=0))
    assert eng.stats["preemptions"] == 2 and eng.kv.used_pages == 0
    path = os.path.join(str(tmp_path), "snap.json")
    recovery.save_snapshot(eng, path)
    if dest == "port":
        dst, rec = _port_engine(ct, tparams, "kernels"), recovery
    else:
        dst = JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS),
                      max_batch=2, max_len=48)
        rec = jrecovery
    restored = rec.restore(dst, rec.load_snapshot(path))
    assert set(restored) | set(before) == {0, 1, 2}
    after = dst.run()
    for u in want:
        out = (before.get(u) or after[u]).output
        assert [int(t) for t in out] == list(want[u]), f"request {u}"
    if dest == "port":
        _drained(dst)


# ---------------------------------------------------------------------------
# artifacts, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifacts_cross_the_packages(tmp_path, dtype):
    """A JAX-saved zamba2 artifact (the unstacked shared block among the
    leaves) loads leaf for leaf in the port, and the port's ``save`` of it
    loads leaf for leaf in JAX."""
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
    shared = m.params["shared_attn"]
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert shared["ln1"].dtype == shared["ln2"].dtype == want
    assert shared["attn"]["wq"]["s1"].dtype == torch.float32
    assert shared["ffn"]["w_down"]["qv"].dim() == 2
    m.save(str(tmp_path / "port"))
    back = japi.NanoQuantModel.load(str(tmp_path / "port"))
    leaves_equal(jparams, back.params)


def test_serve_cli_serves_zamba():
    """``python -m repro_torch.launch.serve --arch zamba2-1.2b`` quantizes
    the smoke teacher on the CPU (the demo) and serves it over the ring
    pool beside the per-slot state."""
    # the CLI quantizes its demo teacher first: one thread, as the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--requests", "3", "--prompt-len", "6",
         "--max-new", "4", "--max-batch", "2", "--page-size", "4"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "zamba2-1.2b-smoke (bfloat16) teacher from seed 0" in out.stdout
    assert "[serve] quantized random-init teacher (demo)" in out.stdout
    assert "3 ring pages per slot" in out.stdout
    assert "per-slot state" in out.stdout
    assert "3 requests, 12 tokens" in out.stdout
