"""Tensor-parallel serving of the SSM, hybrid and VLM families in the port
(``InferenceEngine(mesh=)`` for mamba2-370m, zamba2-1.2b and
llama-3.2-vision-90b) against the JAX package, on the CPU.

- One spawn of two gloo ranks (``tests/_torch_tp_ranks.py::
  state_checks``) runs a Mamba2 mixer of each Mamba2 family on the rank's
  SSD heads (the full sequence past one chunk and one recurrent step, the
  new state's shards gathered) against JAX's unsharded mixer at f32
  1e-5, the same mixer with the gated norm taken over each rank's own
  columns (which must miss), the VLM's forward with an image over the
  rank's shards (the smoke config, and a variant with one kv head whose
  image K/V every rank holds whole) against JAX's unsharded forward at
  f32 1e-5, and the TP engines of the three smoke configs in f32 against
  JAX's *unsharded* engine, on the pool (the SSM's state cache) and on
  the rectangle, with the collectives and launches per forward. The JAX
  runs are made in this process while the ranks run.
- The refusals the families bring: a hybrid whose shared block's wo
  cannot split, and the VLM's image K/V, which a rank holds by kv head or
  whole, never by image row (SSD heads that do not divide the ranks are
  ``tests/test_torch_sharding.py::test_tp_refuses_other_families``).
- ``launch.serve --tp 2 --tp-backend gloo`` serves a zamba2 artifact.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
from _torch_common import (assert_close, draw_prompts, f32, jax_engine,
                           jax_tree, one_torch_thread,  # noqa: F401
                           packed_model, tokens, tol)
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.api import NanoQuantModel
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging as tpaging
from repro_torch.serve.engine import InferenceEngine, check_tp_layout
from repro_torch.sharding import rules as trules
from repro_torch.testing import image_embeds

ARCHS = {"mamba": "mamba2-370m", "zamba": "zamba2-1.2b",
         "vision": "llama-3.2-vision-90b"}
# the family tests' selection: mamba2's wdt (64 -> 8) stays FP, zamba2's
# six mixer projections all pack, the VLM's wk / wv (64 -> 32) pack
MIN_DIM = {"mamba": 16, "zamba": 8, "vision": 16}
# a 1-token prompt (the recurrent step), one past a chunk, mid-flight
# admissions into reused slots (2 slots for 5 requests); no 2-token prompt
# (the reference's engine reads a stale conv ring row there, ROADMAP §3)
LENS, BUDGETS = [5, 1, 21, 1, 5], [6, 4, 5, 7, 3]
PS = 8
# zamba2's rings wrapped (the hybrid test's trace): window 16 on pages of
# 8, budgets that carry every request's writes past 16 rows
WRAP_WINDOW, WRAP_LENS, WRAP_BUDGETS = 16, [5, 7, 1, 12], [26, 20, 30, 9]
STATE = ("ssm", "conv_x", "conv_B", "conv_C")


def _configs(key, **over):
    cj = f32(jconfigs.get_smoke(ARCHS[key]))
    ct = f32(get_smoke(ARCHS[key]))
    cj, ct = (dataclasses.replace(c, **over) for c in (cj, ct))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


def _mesh(rank=0, n=2):
    """The port's mesh of one rank without a process group."""
    return tmesh.Mesh(("data", "model"), (1, n), {"data": 0, "model": rank},
                      None, torch.device("cpu"), "gloo")


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict)
            else np.ascontiguousarray(v[0]) for k, v in tree.items()}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    out = {"budgets": BUDGETS, "prompts": {}}
    for key in ARCHS:
        cj, ct = _configs(key)
        out[key] = packed_model(ct, 0, min_dim=MIN_DIM[key])
        out[f"{key}_cfg"], out[f"{key}_jcfg"] = ct, cj
        out["prompts"][key] = draw_prompts(ct, LENS, seed=4)
    for key in ("mamba", "zamba"):
        out[f"{key}_mixer"] = _layer0(out[key]["layers"]["mixer"])
    out["zamba_wrap_jcfg"], out["zamba_wrap_cfg"] = _configs(
        "zamba", sliding_window=WRAP_WINDOW)
    out["prompts"]["wrap"] = draw_prompts(out["zamba_cfg"], WRAP_LENS, seed=4)
    out["wrap_budgets"] = WRAP_BUDGETS
    ct = out["mamba_cfg"]
    gn = ct.ssm_groups * ct.ssm_state
    out["mixer_x"] = rng.standard_normal((3, 21, ct.d_model)).astype(
        np.float32)
    out["mixer_x1"] = rng.standard_normal((3, 1, ct.d_model)).astype(
        np.float32)
    out["mixer_state"] = {
        "ssm": rng.standard_normal((3, ct.ssm_heads, ct.ssm_head_dim,
                                    ct.ssm_state)).astype(np.float32),
        "conv_x": rng.standard_normal((3, 3, ct.d_inner)).astype(np.float32),
        "conv_B": rng.standard_normal((3, 3, gn)).astype(np.float32),
        "conv_C": rng.standard_normal((3, 3, gn)).astype(np.float32)}
    # the VLM with one kv head: wk / wv and the image K/V whole on both
    # ranks, each rank's two query heads reading that head
    cj, ct = _configs("vision", n_kv_heads=1)
    out["vision_kv1"] = packed_model(ct, 1, min_dim=MIN_DIM["vision"])
    out["vision_kv1_cfg"], out["vision_kv1_jcfg"] = ct, cj
    out["image_tokens"] = tokens(ct, (2, 11), 1)
    out["image"] = image_embeds(ct, 2, 3)
    return out


def _jax_mixer(case, key):
    """JAX's unsharded mixer on the plain oracles: (full output, its
    terminal state, step output, its new state)."""
    cj = case[f"{key}_jcfg"]
    jp = jax_tree(case[f"{key}_mixer"])
    st = jax_tree(case["mixer_state"])
    with jops.kernel_policy(jops.KernelPolicy(mode="ref")):
        y, _ = jax.jit(lambda p, x: JL.mamba2(p, cj, x, None))(
            jp, case["mixer_x"])
        zeros = JT.init_cache(cj, 3, 8)["layers"]
        _, new = jax.jit(lambda p, x: JT._mamba_prefill(
            p, cj, x, {k: v[0] for k, v in zeros.items()}))(
                jp, case["mixer_x"])
        y1, new1 = jax.jit(lambda p, x, s: JL.mamba2(p, cj, x, s))(
            jp, case["mixer_x1"], st)
    return {"full": (np.asarray(y), {k: np.asarray(new[k]) for k in STATE}),
            "step": (np.asarray(y1),
                     {k: np.asarray(new1[k]) for k in STATE})}


def _jax_runs(case):
    """JAX's unsharded engines on the traces, one per family (its pool;
    the families' own tests hold JAX's rectangle to its pool), and its
    mixers and VLM forwards."""
    runs, out = {}, {}
    for key in ARCHS:
        toks, stats, _ = jax_engine(runs, case[f"{key}_jcfg"],
                                    jax_tree(case[key]),
                                    case["prompts"][key], BUDGETS,
                                    page_size=PS)
        out[key] = ({u: np.asarray(t).tolist() for u, t in toks.items()},
                    stats)
    toks, _, _ = jax_engine(runs, case["zamba_wrap_jcfg"],
                            jax_tree(case["zamba"]), case["prompts"]["wrap"],
                            WRAP_BUDGETS, page_size=PS)
    out["zamba_wrap"] = {u: np.asarray(t).tolist() for u, t in toks.items()}
    for key in ("mamba", "zamba"):
        out[f"{key}_mixer"] = _jax_mixer(case, key)
    for key in ("vision", "vision_kv1"):
        cj = case[f"{key}_jcfg"]
        out[f"{key}_forward"] = np.asarray(jax.jit(
            lambda p, t, i: JT.forward(p, cj, t, i))(
                jax_tree(case[key]), case["image_tokens"], case["image"]))
    return out


@pytest.fixture(scope="module")
def results(case, tmp_path_factory):
    """(the ranks' results, JAX's runs): the two gloo ranks run in their
    own processes while JAX's engines run here."""
    got = {}

    def ranks():
        try:
            got["ranks"] = tmesh.run_ranks(
                R.state_checks, R.TP, "gloo", args=(case,),
                workdir=str(tmp_path_factory.mktemp("tps")), threads=1)
        except BaseException as e:      # re-raised in the test's thread
            got["error"] = e
    t = threading.Thread(target=ranks)
    t.start()
    try:
        jax_runs = _jax_runs(case)
    finally:
        t.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], jax_runs


# ---------------------------------------------------------------------------
# two gloo ranks against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["full", "step"])
@pytest.mark.parametrize("key", ["mamba", "zamba"])
def test_mixer_on_ssd_heads_matches_jax(case, results, key, route):
    """A Mamba2 mixer on each rank's 4 of 8 SSD heads (dt, A_log, D and
    dt_bias cut to them, B / C repeated out to heads and cut, the gated
    norm's sum of squares all-reduced, out_proj row-parallel): the output
    on every rank and the new state's shards (ssm on heads, conv_x on
    d_inner, conv_B / conv_C whole and equal on both ranks), gathered in
    rank order, equal JAX's unsharded mixer at f32 1e-5. mamba2's wdt is
    FP, zamba2's packed."""
    ranks, jax_runs = results
    want_y, want_st = jax_runs[f"{key}_mixer"][route]
    got = [ranks[r]["mixer"][key][route] for r in range(2)]
    for y, _ in got:
        assert_close(want_y, y, tol("f32"), f"{key} mixer {route}")
    for k in STATE:
        parts = [st[k] for _, st in got]
        if k in ("conv_B", "conv_C"):
            np.testing.assert_array_equal(parts[0], parts[1])
            full = parts[0]
        else:
            full = np.concatenate(parts, axis=1 if k == "ssm" else -1)
        assert full.shape == want_st[k].shape, k
        assert_close(want_st[k], full, tol("f32"), f"{key} {route} {k}")


@pytest.mark.parametrize("key", ["mamba", "zamba"])
def test_gated_norm_statistics_are_all_reduced(case, results, key):
    """The gated norm spans all of d_inner: a rank that normed its own
    shard (no all-reduce of the sum of squares) misses JAX's mixer by far
    more than the tolerance, which the test above holds."""
    ranks, jax_runs = results
    want_y = jax_runs[f"{key}_mixer"]["full"][0]
    for r in range(2):
        own = ranks[r]["mixer"][key]["own_norm"]
        err = np.abs(own - want_y).max() / max(1.0, np.abs(want_y).max())
        assert err > 100 * tol("f32"), (key, r, err)


@pytest.mark.parametrize("key", ["vision", "vision_kv1"])
def test_vlm_forward_with_an_image_matches_jax(case, results, key):
    """The VLM's ``forward(tokens, image_embeds)`` over each rank's shards
    (the image K/V of its kv heads: wk / wv column shards, or whole with
    one kv head) equals JAX's unsharded forward at f32 1e-5 on both
    ranks."""
    ranks, jax_runs = results
    cfg = case[f"{key}_cfg"]
    hkv = cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0 else cfg.n_kv_heads
    for r in ranks.values():
        assert r[f"{key}_wk"][-1] == hkv * cfg.head_dim
        assert_close(jax_runs[f"{key}_forward"], r[f"{key}_forward"],
                     tol("f32"), f"{key} forward rank {r['rank']}")


@pytest.mark.parametrize("layout", ["paged", "rect"])
@pytest.mark.parametrize("key", list(ARCHS))
def test_tp_engine_tokens_equal_unsharded_jax(case, results, key, layout):
    """Every rank's f32 greedy tokens equal JAX's unsharded engine's, on
    the pool (the SSM's per-slot state) and on the rectangle; the pool
    drained; each rank's state holds its SSD heads and d_inner columns
    (conv_B / conv_C whole), its pool or rectangle its kv heads."""
    ranks, jax_runs = results
    want, _ = jax_runs[key]
    cfg = case[f"{key}_cfg"]
    for r in ranks.values():
        res = r[f"{key}_{layout}"]
        assert res["tokens"] == want
        assert res["drained"]
    cache = ranks[0][f"{key}_{layout}"]["cache"]
    if cfg.is_ssm_layer_stack:
        st = cache["layers"]
        assert st["ssm"][2] == cfg.ssm_heads // 2
        assert st["conv_x"][-1] == cfg.d_inner // 2
        assert st["conv_B"][-1] == cfg.ssm_groups * cfg.ssm_state
    for stack in ("shared_attn", "self_layers", "cross_kv"):
        if stack in cache:
            assert cache[stack]["k"][-2:] == (cfg.n_kv_heads // 2,
                                              cfg.head_dim), stack
    if cfg.family == "vlm":
        assert cache["cross_kv"]["k"][-3] == cfg.n_image_tokens


def test_tp_hybrid_rings_wrap_as_unsharded_jax(case, results):
    """zamba2 at window 16 (a ring of 2 pages of 8 per slot): every
    request writes past its ring's 16 rows on each rank's 2 of 4 kv
    heads; every rank's tokens equal JAX's unsharded paged engine's and
    the pool drains."""
    ranks, jax_runs = results
    assert all(n + b - 2 >= WRAP_WINDOW
               for n, b in zip(WRAP_LENS, WRAP_BUDGETS))
    for r in ranks.values():
        res = r["zamba_wrap"]
        assert res["tokens"] == jax_runs["zamba_wrap"] and res["drained"]
        assert res["cache"]["shared_attn"]["k"][1:] == (
            WRAP_WINDOW // PS * 2 + 1, PS, 2, case["zamba_cfg"].head_dim)


@pytest.mark.parametrize("key", list(ARCHS))
def test_tp_collectives_and_launches_per_forward(case, results, key):
    """Per forward (an admission's prefill or a decode step), on each rank:
    one all-gather of the logits; all-reduces 2 per Mamba2 layer (the
    gated norm's statistics and out_proj), 2 per attention block (wo and
    w_down; the hybrid's shared block per application, the VLM's self and
    cross blocks alike) and 1 for the embedding; #1 for each packed mixer
    projection (mamba2 5, zamba2 6), 4 per attention block (merged QKV,
    wo, merged gate-up, w_down; the cross block's wq instead of QKV: no
    image, so no wk / wv); #2 once per attention block of a paged decode
    step (never on the rectangle), #4 never (every rank is #1's)."""
    ranks, _ = results
    cfg = case[f"{key}_cfg"]
    mixer = {"mamba": 5, "zamba": 6, "vision": 0}[key]
    apps = TT.n_shared_apps(cfg)
    blocks = apps if cfg.is_ssm_layer_stack else cfg.n_layers
    layers = cfg.n_layers if cfg.is_ssm_layer_stack else 0
    for layout in ("paged", "rect"):
        for r in ranks.values():
            res = r[f"{key}_{layout}"]
            st, c = res["stats"], res["comm"]
            forwards = st["admissions"] + st["decode_steps"]
            assert c["all_gather"] == forwards
            assert c["all_reduce"] == (2 * layers + 2 * blocks + 1) \
                * forwards
            assert len(res["grids"]) == (mixer * layers + 4 * blocks) \
                * forwards
            self_blocks = blocks if cfg.family != "vlm" \
                else cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
            paged = layout == "paged" and cfg.family != "ssm"
            assert res["paged"] == (self_blocks * st["decode_steps"]
                                    if paged else 0)
            assert res["packed"] == 0


# ---------------------------------------------------------------------------
# the refusals and the CLI
# ---------------------------------------------------------------------------


def test_check_tp_layout_walks_the_shared_block():
    """``check_tp_layout`` walks the hybrid's unstacked shared block: a
    variant with two heads of 16 packs the shared wo's d_in of 32 into
    one word, which two ranks cannot split, and is refused naming it; the
    smoke config passes, its mixers' wB / wC / wdt whole on each rank."""
    _, ct = _configs("zamba")
    params = R.params_from_numpy(packed_model(ct, 0, min_dim=8), "cpu")
    for rank in (0, 1):
        check_tp_layout(ct, params, _mesh(rank))
    local = tsurgery.place_on_mesh(params, ct, _mesh(1))["layers"]["mixer"]
    for name in ("wB", "wC", "wdt"):
        assert local[name]["qu_t"] is params["layers"]["mixer"][name]["qu_t"]
    narrow = dataclasses.replace(ct, n_heads=2, n_kv_heads=2)
    with pytest.raises(NotImplementedError,
                       match="shared_attn/attn/wo/.* split on its d_in"):
        check_tp_layout(narrow, R.params_from_numpy(
            packed_model(narrow, 0, min_dim=8), "cpu"), _mesh())


def test_image_kv_is_held_by_kv_head_never_by_image_row():
    """The VLM's per-slot image K/V under its rule of the rectangle: over
    two ranks each holds its kv head of the smoke config's two; over four
    the heads do not divide and the reference's rule falls back to the
    image rows, which explicit TP has no regather for: the rank's cache
    (``local_cache``: the engine's pool and rectangle alike) holds every
    row and both heads, its query head reads its GQA group's one
    (``kv_layout``). Over four the smoke config is refused all the same:
    its wo packs d 64 into 2 words."""
    _, ct = _configs("vision")
    full = TT.image_cache(ct, 2, "meta")["k"].shape
    for n, hkv in ((2, 1), (4, ct.n_kv_heads)):
        m = _mesh(n - 1, n)
        pool = tpaging.init_paged_cache(ct, 3, 8, device="cpu", batch=2,
                                        mesh=m)
        rect = tsurgery.local_cache(lambda d: TT.init_cache(ct, 2, 16, d),
                                    ct, m, "cpu")
        for cache in (pool, rect):
            assert tuple(cache["cross_kv"]["k"].shape) == \
                full[:3] + (hkv, ct.head_dim)
    four = _mesh(3, 4)
    spec = trules.cache_pspecs(ct, {"cross_kv": TT.image_cache(
        ct, 2, "meta")}, four, trules.SERVE, paged=True)["cross_kv"]["k"]
    assert spec[2] == "model"               # the rule's row fallback
    assert tsurgery.kv_layout(ct, four) == (True, slice(1, 2))
    with pytest.raises(NotImplementedError, match="split on its d_in"):
        InferenceEngine(R.params_from_numpy(packed_model(ct, 0), "cpu"), ct,
                        device="cpu", mesh=four)


def test_launch_serve_tp_hybrid_artifact(case, tmp_path, monkeypatch):
    """``launch.serve --quantized-ckpt DIR --tp 2 --tp-backend gloo`` on a
    zamba2 artifact serves every request, and its tokens (sampled from
    the seed) equal the unsharded CLI's."""
    from repro_torch.launch import serve
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    art = NanoQuantModel.from_numpy(
        case["zamba"], case["zamba_cfg"], device="cpu",
        quant={"target_bpw": 1.0, "min_dim": MIN_DIM["zamba"]}).save(
            str(tmp_path / "nq"))
    argv = ["--device", "cpu", "--quantized-ckpt", art, "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-batch", "2",
            "--page-size", str(PS)]
    want = serve.main(argv)
    got = serve.main(argv + ["--tp", "2", "--tp-backend", "gloo"])
    assert sorted(got) == [0, 1, 2] and all(len(t) == 4
                                            for t in got.values())
    assert {u: t.tolist() for u, t in got.items()} == \
        {u: t.tolist() for u, t in want.items()}
