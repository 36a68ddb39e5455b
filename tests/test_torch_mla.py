"""The port's MLA attention (deepseek-v2-lite's compressed-latent attention)
against the JAX reference, on deepseek-v2-lite's smoke config (3 layers,
the first dense, 8 experts top-2 plus a shared expert, kv_lora_rank 32,
RoPE 8, nope 16, v 16) packed with ``min_dim=8``, so that every packed
projection of the attention (wq, w_dkv, w_kr, wo) is packed; w_uk and
w_uv stay FP, as the selection rule keeps them.

Covered: ``gather_pages``, ``_cache_valid`` and ``_decode_mask`` (per-slot
rows, S > 1 queries over stale rows past the frontier, a wrapped ring);
``mla_attention`` on its three routes (full sequence, rectangular prefill
at position 0, the paged route at S = 1 and S > 1) in f32 and bf16, on
the plain oracles and on the kernel wrappers' dispatch; the model's
forward, prefill and paged decode over both block stacks; the template
at full size; the merge and the rank view; the engine's greedy tokens
against JAX's plain engine on its rectangular cache (the reference's
``test_mla_paged_identity``), JAX's prefix and speculative engines with
their counters, every pool drained; the latent pool's bytes and copy on
write; artifacts in both directions; the seeded filler's laws;
``launch.serve --arch deepseek-v2-lite-16b``.

Inputs come from ``np.random.default_rng``; tolerances are
``_torch_common.tol`` (relative max-abs f32 1e-5, bf16 3e-2) per layer
and 1e-4 for whole-model logits (``tests/test_torch_model.py``). The
family is MoE, so every engine gate is against JAX's engine of the same
kind (an expert's capacity counts the rows of the call).
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
                           check_paged_decode, check_prefill, drained,
                           draw_prompts, f32, flat_templates, jax_engine,
                           jax_tree, leaves_equal, packed_model, pair,
                           one_torch_thread,  # noqa: F401
                           same_tokens, serve_engine, shared_prompts, tol,
                           torch_params)
from repro import api as japi
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.quant import surgery as jsurgery
from repro.serve import paging as jpaging
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging as tpaging
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.testing import (UNIFORM_LAWS, _normal_law,
                                 random_packed_params,
                                 random_packed_params_device)

ARCH = "deepseek-v2-lite-16b"
MIN_DIM = 8                  # packs w_kr (64 -> 8 at the smoke widths)
LOGITS_TOL = 1e-4
MODES = {"ref": (ops.KernelPolicy(mode="ref"), jops.KernelPolicy(mode="ref")),
         "kernels": (ops.KernelPolicy(mode="cuda"),
                     jops.KernelPolicy(mode="pallas", interpret=True))}
PACKED = ("wq", "w_dkv", "w_kr", "wo")


def _configs():
    cj, ct = f32(jconfigs.get_smoke(ARCH)), f32(tconfigs.get_smoke(ARCH))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.is_mla and ct.first_k_dense == 1
    return cj, ct


def _model(seed=0, bpw=1.0):
    cj, ct = _configs()
    tree = packed_model(ct, seed=seed, min_dim=MIN_DIM, bpw=bpw)
    return cj, ct, tree, jax_tree(tree), torch_params(tree)


@pytest.fixture(scope="module")
def model():
    return _model()


def _tparams(tparams, mode):
    if MODES[mode][0].use_merged_projections("cpu"):
        return tsurgery.merge_projection_groups(tparams)
    return tparams


# ---------------------------------------------------------------------------
# the paged read's helpers
# ---------------------------------------------------------------------------


def test_gather_pages_matches_jax():
    """Both leaf shapes of the latent pool, ragged tables, an all-null
    slot."""
    rng = np.random.default_rng(0)
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    for shape in ((6, 4, 32), (6, 4, 1, 8)):
        pool = rng.standard_normal(shape).astype(np.float32)
        want = JL.gather_pages(jnp.asarray(pool), jnp.asarray(bt))
        got = TL.gather_pages(torch.from_numpy(pool), torch.from_numpy(bt))
        assert tuple(got.shape) == (3, 16) + shape[2:]
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


# (q_pos, cache_pos, n_rows, window)
MASK_CASES = {
    # one query per slot at its own row
    "slots": ([[9], [5], [0]], [9, 5, 0], 16, 0),
    # a verify: 3 queries per slot; rows past each query's own hold stale
    # keys of later queries of the call and must reconstruct as negative
    "verify": ([[6, 7, 8], [2, 3, 4], [0, 1, 2]], [6, 2, 0], 16, 0),
    # a ring of 16 rows: cache_pos = q_pos mod 16, the second slot's
    # writes wrapping mid-call, under a window
    "ring": ([[20, 21, 22], [30, 31, 32]], [4, 14], 16, 12),
    # one shared (scalar) position for the batch
    "scalar": ([5, 6, 7], 5, 12, 0),
    "window": ([[9], [13]], [9, 13], 16, 4),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_decode_mask_and_cache_valid_match_jax(case):
    q, cp, n_rows, window = MASK_CASES[case]
    q = np.asarray(q, np.int32)
    cp = np.asarray(cp, np.int32)
    want = JL._decode_mask(jnp.asarray(q), jnp.asarray(cp) if cp.ndim
                           else int(cp), n_rows, window)
    got = TL._decode_mask(torch.from_numpy(q).long(),
                          torch.from_numpy(cp).long() if cp.ndim
                          else int(cp), n_rows, window)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    k_pos = np.arange(n_rows)
    S = q.shape[-1]
    want = JL._cache_valid(jnp.asarray(k_pos), jnp.asarray(cp) if cp.ndim
                           else int(cp), S)
    got = TL._cache_valid(torch.from_numpy(k_pos), torch.from_numpy(cp).long()
                          if cp.ndim else int(cp), S)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# mla_attention on its three routes
# ---------------------------------------------------------------------------


def _attn_params(ct, dt):
    """Layer 0's attention dict of the seeded model (numpy), and the pair
    of it in `dt` (FP leaves cast, packed leaves as stored)."""
    tree = packed_model(ct, seed=3, min_dim=MIN_DIM)["layers"]["attn"]
    p = {k: {kk: np.ascontiguousarray(vv[0]) for kk, vv in v.items()}
         if isinstance(v, dict) else np.ascontiguousarray(v[0])
         for k, v in tree.items()}
    assert all("qu_t" in p[k] for k in PACKED)
    assert set(p["w_uk"]) == set(p["w_uv"]) == {"w"}
    jp, tp = jax_tree(p), params_from_numpy(p, "cpu")
    if dt == "bf16":
        jp = cast_jax(jp, jnp.bfloat16)
        tp = params_from_numpy(tp, "cpu", torch.bfloat16)
    return jp, tp


PAGED_BT = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)


def _route_inputs(ct, route, dt, rng):
    """(x, positions, cache (numpy leaves or None), cache_pos, block
    table) of one route; S = 7 for the full and prefill routes, 1 for a
    decode, 3 for a verify whose pool holds stale rows past the
    frontier; the rectangle's decode and 3-token call at per-slot offsets
    over a rectangle of 12 noisy rows (stale past each slot's offset)."""
    B = 3 if route.startswith(("paged", "rect")) else 2
    S = {"full": 7, "prefill": 7, "paged-decode": 1, "paged-verify": 3,
         "rect-decode": 1, "rect-verify": 3}[route]
    x = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
    dc, dr = ct.kv_lora_rank, ct.qk_rope_dim
    if route == "full":
        return x, np.arange(S, dtype=np.int32), None, None, None
    if route == "prefill":
        cache = {"c_kv": np.zeros((B, 12, dc), np.float32),
                 "k_rope": np.zeros((B, 12, 1, dr), np.float32)}
        return x, np.arange(S, dtype=np.int32), cache, 0, None
    cp = np.array([9, 5, 2], np.int32) if S == 1 else \
        np.array([6, 2, 0], np.int32)
    pos = cp[:, None] + np.arange(S, dtype=np.int32)[None]
    if route.startswith("rect"):
        cache = {"c_kv": rng.standard_normal((B, 12, dc)).astype(np.float32),
                 "k_rope": rng.standard_normal((B, 12, 1, dr)
                                               ).astype(np.float32)}
        return x, pos, cache, cp, None
    cache = {"c_kv": rng.standard_normal((6, 4, dc)).astype(np.float32),
             "k_rope": rng.standard_normal((6, 4, 1, dr)).astype(np.float32)}
    pos = cp[:, None] + np.arange(S, dtype=np.int32)[None]
    return x, pos, cache, cp, PAGED_BT


ROUTES = ["full", "prefill", "paged-decode", "paged-verify", "rect-decode",
          "rect-verify"]


@pytest.mark.parametrize("route,dt,mode", [
    (r, dt, "ref") for r in ROUTES for dt in ("f32", "bf16")]
    + [("paged-verify", dt, "kernels") for dt in ("f32", "bf16")])
def test_mla_attention_matches_jax(route, dt, mode):
    """The output and every written cache row against JAX's
    ``mla_attention`` on the same inputs (the rectangular prefill attends
    over its S rows, JAX's over the max_len rectangle with the rows past S
    masked): every route on the plain oracles, and the paged S > 1 route,
    the one that reads the most, on the kernel wrappers' dispatch against
    JAX's Pallas kernels in interpret mode. In f32 the ``ref`` cases also
    hold the port's kernel dispatch against the same JAX result (the two
    differ only in summation order there)."""
    cj, ct = _configs()
    if dt == "bf16":
        cj, ct = (dataclasses.replace(c, dtype="bfloat16") for c in (cj, ct))
    jp, tp = _attn_params(ct, dt)
    rng = np.random.default_rng(10 + len(route))
    x, pos, cache, cp, bt = _route_inputs(ct, route, dt, rng)
    jx, tx = pair(x, dt)
    jc = tc = None
    if cache is not None:
        jc = {k: pair(v, dt)[0] for k, v in cache.items()}
        tc = {k: pair(v, dt)[1] for k, v in cache.items()}
    jcp = tcp = cp
    if isinstance(cp, np.ndarray):
        jcp, tcp = jnp.asarray(cp), torch.from_numpy(cp).long()
    jbt = tbt = None
    if bt is not None:
        jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    tpol, jpol = MODES[mode]
    with jops.kernel_policy(jpol):
        want, jcache = jax.jit(lambda *a: JL.mla_attention(
            a[0], cj, *a[1:]))(jp, jx, jnp.asarray(pos), jc, jcp, jbt)
    with ops.kernel_policy(tpol):
        got, tcache = TL.mla_attention(tp, ct, tx,
                                       torch.from_numpy(pos).long(), tc, tcp,
                                       tbt)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_close(want, got, tol(dt), f"mla {route} {dt} {mode}")
    if mode == "ref" and dt == "f32":
        tc2 = None if tc is None else {k: pair(v, dt)[1]
                                       for k, v in cache.items()}
        with ops.kernel_policy(MODES["kernels"][0]):
            got2, _ = TL.mla_attention(tp, ct, tx,
                                       torch.from_numpy(pos).long(), tc2,
                                       tcp, tbt)
        assert_close(want, got2, tol(dt), f"mla {route} f32 kernel dispatch")
    if cache is None:
        assert jcache is None
        return
    for leaf in ("c_kv", "k_rope"):
        a, b = jcache[leaf], tcache[leaf]
        if bt is not None:           # the null page 0 is trash by design
            a, b = a[1:], b[1:]
        assert_close(a, b, tol(dt), f"mla {route} {dt} {mode} cache {leaf}")


def test_mla_never_reaches_the_attention_kernels(model, monkeypatch):
    """MLA's read is plain torch ops on every route: neither the paged
    attention wrapper nor the decode megakernel is called, on the kernel
    path too."""
    _, ct, _, _, tparams = model

    def boom(*a, **k):
        raise AssertionError("an attention kernel was reached")
    monkeypatch.setattr(ops, "paged_attention", boom)
    monkeypatch.setattr(ops, "decode_step_megakernel", boom)
    with ops.kernel_policy(MODES["kernels"][0]):
        eng = InferenceEngine(tparams, ct, ServeConfig(greedy=True,
                                                       page_size=PS),
                              max_batch=2, max_len=48, device="cpu",
                              policy=MODES["kernels"][0])
        out = serve_engine(eng, Request, draw_prompts(ct, [5, 11]), [3, 3], False)
    assert all(len(o) == 3 for o in out.values())


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_matches_jax(model, dt):
    """The full-sequence forward through both stacks: f32 on the kernel
    wrappers' dispatch; the bf16 model (FP leaves cast, w_uk / w_uv among
    them, the router kept f32) on the plain oracles against JAX's bf16
    model at the bf16 tolerance."""
    cj, ct, tree, jparams, tparams = model
    if dt == "f32":
        check_forward(cj, jparams, _tparams(tparams, "kernels"),
                      MODES["kernels"][0], LOGITS_TOL, f"{cj.name} f32")
        return
    m = NanoQuantModel.from_numpy(tree, dataclasses.replace(
        ct, dtype="bfloat16"), device="cpu", dtype=torch.bfloat16)
    assert m.params["layers"]["attn"]["w_uk"]["w"].dtype == torch.bfloat16
    assert m.params["layers"]["moe"]["router"]["w"].dtype == torch.float32
    check_forward(dataclasses.replace(cj, dtype="bfloat16"),
                  cast_jax(jparams, jnp.bfloat16), m.params,
                  MODES["ref"][0], tol("bf16"), f"{cj.name} bf16")


def test_prefill_matches_jax(model):
    """Logits and both stacks' c_kv / k_rope rows of a bucket-padded
    prefill into the rectangular cache, on the kernel wrappers'
    dispatch."""
    cj, _, _, jparams, tparams = model
    check_prefill(cj, jparams, _tparams(tparams, "kernels"),
                  MODES["kernels"][0], LOGITS_TOL, f"{cj.name} kernels")


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_decode_step_matches_jax(model, mode):
    """One decode step over the latent pools of both stacks (the dense
    first layer's and the MoE layers'), read through the same tables."""
    cj, ct, _, jparams, tparams = model
    assert TT.cache_leaves(ct) == {"c_kv": (32,), "k_rope": (1, 8)}
    assert sorted(TT.stack_depths(ct)) == ["dense_layers", "layers"]
    check_paged_decode(cj, jparams, _tparams(tparams, mode), MODES[mode][0],
                       LOGITS_TOL, f"{cj.name} {mode}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_size_template_matches_jax(dtype):
    """deepseek-v2-lite-16b at full size, shapes only: the port's template
    equals JAX's leaf for leaf, with the ranks at 1.0 bpw that kernel #1
    runs at on the card."""
    cfg_t = dataclasses.replace(tconfigs.get_config(ARCH), dtype=dtype)
    cfg_j = dataclasses.replace(jconfigs.get_config(ARCH), dtype=dtype)
    flat_w, flat_g = flat_templates(
        jsurgery.abstract_quantized_params(cfg_j),
        tsurgery.abstract_quantized_params(cfg_t))
    assert flat_w == flat_g
    t = tsurgery.abstract_quantized_params(cfg_t)
    attn, moe = t["layers"]["attn"], t["layers"]["moe"]
    assert attn["w_uk"] == {"w": tsurgery.LeafSpec((26, 512, 2048), dtype)}
    assert attn["w_uv"] == {"w": tsurgery.LeafSpec((26, 512, 2048), dtype)}
    assert attn["kv_norm"] == tsurgery.LeafSpec((26, 512), dtype)
    assert moe["router"] == {"w": tsurgery.LeafSpec((26, 2048, 64),
                                                    "float32")}
    ranks = {k: attn[k]["qv"].shape[-1] for k in PACKED}
    assert ranks == {"wq": 1184, "w_dkv": 384, "w_kr": 32, "wo": 992}
    assert attn["w_kr"]["qu_t"].shape == (26, 1, 64)
    assert moe["w_gate"]["qv"].shape == (26, 64, 64, 800)
    assert moe["w_down"]["qu_t"].shape == (26, 64, 25, 2048)
    assert moe["shared"]["w_gate"]["qv"].shape[-2:] == (64, 1152)
    dense = t["dense_layers"]["ffn"]
    assert dense["w_down"]["qv"].shape == (1, 342, 1696)
    assert t["dense_layers"]["attn"]["wq"]["qv"].shape == (1, 64, 1184)


def test_merge_and_rank_view_match_jax():
    """The merge leaves the MLA attention unmerged (no group has wq with
    w_dkv / w_kr) and merges the shared expert's and the dense block's
    gate-up, as JAX's; the rank view truncates the four packed
    projections of the attention to JAX's ranks."""
    cj, ct, _, jparams, tparams = _model(bpw=6.0)
    merged = tsurgery.merge_projection_groups(tparams)
    jm = jax.tree_util.tree_flatten_with_path(
        jsurgery.merge_projection_groups(jparams))[0]
    tm = jax.tree_util.tree_flatten_with_path(merged)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jm] == \
        [jax.tree_util.keystr(k) for k, _ in tm]
    for stack in ("layers", "dense_layers"):
        assert "wqkv" not in merged[stack]["attn"]
    assert "wgu" in merged["layers"]["moe"]["shared"]
    assert "wgu" in merged["dense_layers"]["ffn"]
    jview = jsurgery.rank_truncated_view(jparams, 0.5)
    tview = tsurgery.rank_truncated_view(TT.split_layers(tparams), 0.5)
    for stack in ("layers", "dense_layers"):
        ja, ta = jview[stack]["attn"], tview[stack][0]["attn"]
        for k in PACKED:
            r = int(ta[k]["qv"].shape[-1])
            assert int(ja[k].get("eff_rank", r)) == \
                ta[k].get("eff_rank", r), k
        assert ta["wq"]["eff_rank"] < ta["wq"]["qv"].shape[-1]
        assert "eff_rank" not in ta["w_uk"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


LENS, BUDGETS = [3, 9, 14, 5, 12], [6, 3, 5, 8, 4]
PS = 8
SPEC_KEYS = ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_rollback_tokens", "spec_rollback_pages", "decode_steps",
             "tokens_emitted", "preemptions")
PREFIX_KEYS = ("prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
               "evicted_pages", "shared_pages", "preemptions")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's engine runs, each made once and shared by the port's modes."""
    return {}


def _port_engine(ct, tparams, mode, **kw):
    return InferenceEngine(tparams, ct, ServeConfig(greedy=True, page_size=PS,
                                                    debug=True, **kw),
                           max_batch=2, max_len=48, device="cpu",
                           policy=MODES[mode][0])


@pytest.mark.parametrize("mode", list(MODES))
def test_mla_paged_identity(model, jax_runs, mode):
    """Plain decoding, admitted mid-flight: the port's paged latent pool
    against JAX's plain engine on its rectangular cache (``paged=False``),
    the reference's ``tests/test_paging.py::test_mla_paged_identity``
    across the packages. Tokens, admission steps and decode steps are
    identical (the reference holds its own paged engine to the same
    tokens)."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS)
    want, jstats, jsteps = jax_engine(jax_runs, cj, jparams, prompts,
                                      BUDGETS, page_size=PS, paged=False)
    teng = _port_engine(ct, tparams, mode, prefix_cache=False)
    assert set(teng.cache["layers"]) == {"c_kv", "k_rope"}
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    assert teng.admission_step == jsteps
    assert teng.stats["decode_steps"] == jstats["decode_steps"]
    drained(teng)


@pytest.mark.parametrize("mode", list(MODES))
def test_mla_rect_engine_matches_jax(model, jax_runs, mode):
    """The port's engine on its rectangular latent cache
    (``ServeConfig(paged=False)``) against JAX's: tokens, admission and
    decode steps and the rectangle's bytes equal, no pool."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS)
    want, jstats, jsteps = jax_engine(jax_runs, cj, jparams, prompts,
                                      BUDGETS, page_size=PS, paged=False)
    teng = _port_engine(ct, tparams, mode, paged=False)
    assert teng.kv is None and set(teng.cache["layers"]) == {"c_kv",
                                                             "k_rope"}
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    assert teng.admission_step == jsteps
    assert teng.stats["decode_steps"] == jstats["decode_steps"]
    B, rows, dc, dr = 2, 48, ct.kv_lora_rank, ct.qk_rope_dim
    assert teng.kv_cache_bytes() == ct.n_layers * B * rows * (dc + dr) * 4


@pytest.mark.parametrize("mode", list(MODES))
def test_prefix_engine_matches_jax_engine(model, jax_runs, mode):
    """Shared latent pages: hits prefill their suffix through the paged
    route, padded as JAX pads it; tokens and counters equal JAX's."""
    cj, ct, _, jparams, tparams = model
    prompts, budgets = shared_prompts(ct, PS)
    want, jstats, _ = jax_engine(jax_runs, cj, jparams, prompts, budgets,
                                 page_size=PS)
    teng = _port_engine(ct, tparams, mode)
    same_tokens(want, serve_engine(teng, Request, prompts, budgets))
    assert {k: teng.stats[k] for k in PREFIX_KEYS} == \
        {k: jstats[k] for k in PREFIX_KEYS}
    assert teng.stats["prefix_hit_tokens"] > 0
    assert teng.stats["cow_copies"] >= 1
    drained(teng)


@pytest.fixture(scope="module")
def spec_model():
    """The smoke model packed at 6 bpw, so that its ranks truncate."""
    return _model(bpw=6.0)


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_engine_matches_jax_engine(spec_model, jax_runs, mode):
    """Self-speculative decoding (half-rank draft, k pinned at 4) over the
    latent pool: the verify writes k+1 latent rows and rolls back by
    trimming pages. Tokens equal JAX's ``SpecDecodeController`` engine's;
    in the unmerged layout its counters too."""
    cj, ct, _, jparams, tparams = spec_model
    kw = dict(prefix_cache=False, spec_rank_frac=0.5, spec_k=4,
              spec_k_min=4)
    prompts = draw_prompts(ct, LENS)
    want, jstats, _ = jax_engine(jax_runs, cj, jparams, prompts, BUDGETS,
                                 page_size=PS, **kw)
    teng = _port_engine(ct, tparams, mode, **kw)
    attn = teng.spec.draft_params["layers"][0]["attn"]
    assert attn["wq"]["eff_rank"] < attn["wq"]["qv"].shape[-1]
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    st = {k: teng.stats[k] for k in SPEC_KEYS}
    assert st["spec_cycles"] > 0 and st["spec_rollback_tokens"] > 0
    if mode == "ref":
        assert st == {k: jstats[k] for k in SPEC_KEYS}
    drained(teng)


def test_latent_pool_bytes_and_copy_on_write():
    """The pool's leaves are c_kv (L, n_pages, ps, dc) and k_rope (L,
    n_pages, ps, 1, dr) per stack, their bytes equal JAX's pool's, and a
    copy on write duplicates a page of every layer of both leaves and
    stacks, nothing else."""
    cj, ct = _configs()
    pool = tpaging.init_paged_cache(ct, 9, 8, "cpu")
    jpool = jpaging.init_paged_cache(cj, 2, 32, n_pages=9, page_size=8)
    for stack, n in (("dense_layers", 1), ("layers", 2)):
        assert {k: tuple(v.shape) for k, v in pool[stack].items()} == {
            "c_kv": (n, 9, 8, 32), "k_rope": (n, 9, 8, 1, 8)}
        assert {k: tuple(v.shape) for k, v in pool[stack].items()} == \
            {k: tuple(v.shape) for k, v in jpool[stack].items()}
    assert tpaging.kv_cache_bytes(pool) == jpaging.kv_cache_bytes(jpool) \
        == 4 * 3 * 9 * 8 * (32 + 8)
    rng = np.random.default_rng(1)
    for leaves in pool.values():
        for t in leaves.values():
            t.copy_(torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    before = {s: {k: v.clone() for k, v in lv.items()}
              for s, lv in pool.items()}
    tpaging.copy_page(pool, 3, 6)
    for s, lv in pool.items():
        for k, v in lv.items():
            want = before[s][k].clone()
            want[:, 6] = before[s][k][:, 3]
            assert torch.equal(v, want), (s, k)


# ---------------------------------------------------------------------------
# artifacts, the seeded filler, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifacts_cross_the_packages(tmp_path, dtype):
    """A JAX-saved deepseek artifact (w_uk / w_uv and kv_norm cast like
    the other FP leaves, the router f32) loads leaf for leaf in the port,
    and the port's ``save`` of it loads leaf for leaf in JAX."""
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
    attn = m.params["layers"]["attn"]
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert attn["w_uk"]["w"].dtype == attn["kv_norm"].dtype == want
    assert attn["w_kr"]["s1"].dtype == torch.float32
    assert m.params["layers"]["moe"]["router"]["w"].dtype == torch.float32
    m.save(str(tmp_path / "port"))
    back = japi.NanoQuantModel.load(str(tmp_path / "port"))
    leaves_equal(jparams, back.params)


def test_seeded_filler_laws():
    """``testing._normal_law``: the latent's norm draws the norm law, the
    FP up projections the FP-weight law N(0, 1/d_in), so activations stay
    O(1) through the depth. The Mamba2 mixer's leaves draw
    ``init_mamba2``'s laws (mamba2-370m's smoke config, both fillers):
    conv kernels N(0, 0.2), conv biases N(0, 0.02), D near 1, A_log in
    [0, log 16] and dt_bias in [log 1e-3, log 1e-1] (uniform), so 48
    seeded layers run a recurrence of a trained model's range."""
    _, ct = _configs()
    attn = tsurgery.param_specs(ct)["layers"]["attn"]
    assert _normal_law("kv_norm", attn["kv_norm"].shape, None) == (1.0, 0.1)
    for k in ("w_uk", "w_uv"):
        mean, std = _normal_law("w", attn[k]["w"].shape, None)
        assert mean == 0.0 and np.isclose(std, 1 / np.sqrt(ct.kv_lora_rank))
    mcfg = tconfigs.get_smoke("mamba2-370m")
    mixer = tsurgery.param_specs(mcfg)["layers"]["mixer"]
    for k in ("conv_x", "conv_B", "conv_C"):
        assert _normal_law(k, mixer[k].shape, None) == (0.0, 0.2)
    for k in ("conv_bx", "conv_bB", "conv_bC"):
        assert _normal_law(k, mixer[k].shape, None) == (0.0, 0.02)
    assert _normal_law("D", mixer["D"].shape, None) == (1.0, 0.1)
    assert set(UNIFORM_LAWS) == {"A_log", "dt_bias"}
    tmpl = {"mixer": {k: mixer[k] for k in ("A_log", "dt_bias", "conv_x")}}
    for draw in (random_packed_params(tmpl, 0)["mixer"],
                 {k: v.numpy() for k, v in random_packed_params_device(
                     tmpl, 0, "cpu")["mixer"].items()}):
        for k, (lo, hi) in UNIFORM_LAWS.items():
            assert lo <= draw[k].min() and draw[k].max() <= hi, k
        assert abs(draw["conv_x"].std() - 0.2) < 0.05
    assert np.isclose(UNIFORM_LAWS["A_log"][1], np.log(16.0))
    assert np.allclose(UNIFORM_LAWS["dt_bias"], np.log([1e-3, 1e-1]))


def test_serve_cli_serves_deepseek(tmp_path):
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b``
    quantizes the smoke teacher on the CPU (the demo) and serves it."""
    # the CLI quantizes its demo teacher first: one thread, as the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--requests", "2", "--prompt-len", "8",
         "--max-new", "4", "--max-batch", "2"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "deepseek-v2-lite-smoke (bfloat16) teacher from seed 0" in \
        out.stdout
    assert "[serve] quantized random-init teacher (demo)" in out.stdout
