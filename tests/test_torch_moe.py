"""The port's MoE family against the JAX reference, on qwen3-moe's smoke
config (8 experts, top-2, packed with ``min_dim=16``) and on a variant
with one shared expert and one leading dense block (``n_shared_experts=1,
first_k_dense=1, dense_d_ff=160``, made with ``dataclasses.replace`` in
both packages).

Covered: the stacked-expert linear (``ops.lowrank_binary_matmul_expert``:
one launch of the grouped kernel over every expert, the two-call chain per
expert, the two-stage oracle) against JAX's in ref and Pallas interpret
mode; the router (top-k ties to the lower expert, as ``jax.lax.top_k``);
the ``moe`` layer, FP and packed, at the default capacity and at one that
drops tokens, against JAX's and against ``moe_dense_oracle``; the whole
model's forward, prefill and paged decode; the engine's greedy tokens
against JAX's engine (plain, prefix cache with its counters, speculative
with its counters in the unmerged layout), every pool drained; artifacts
in both directions; the router kept f32 in a bf16 model; and the families
every JAX arch served by the port.

Inputs come from ``np.random.default_rng``; tolerances are
``_torch_common.tol`` (relative max-abs f32 1e-5, bf16 3e-2) per layer
and 1e-4 for whole-model logits (``tests/test_torch_model.py``). An MoE's
output depends on the rows of the call (an expert's capacity counts
them), so every engine gate is against JAX's engine of the same kind:
a prefix hit's padded suffix and the speculative verify change the rows.
"""
import dataclasses

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
from repro.configs import shapes as jshapes
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.quant import surgery as jsurgery
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import binary_matmul, ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.config import check_family
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.testing import random_packed_params

ARCH = "qwen3-moe-235b-a22b"
LOGITS_TOL = 1e-4
# the port's dispatch structures and JAX's policy for the same arithmetic
MODES = {"ref": (ops.KernelPolicy(mode="ref"), jops.KernelPolicy(mode="ref")),
         "kernels": (ops.KernelPolicy(mode="cuda"),
                     jops.KernelPolicy(mode="pallas", interpret=True)),
         "twocall": (ops.KernelPolicy(mode="cuda", fused=False),
                     jops.KernelPolicy(mode="pallas", interpret=True,
                                       fused=False))}
VARIANT = dict(n_shared_experts=1, first_k_dense=1, dense_d_ff=160)


def _configs(kind):
    """(JAX config, port config) of the smoke model or its variant."""
    cj, ct = f32(jconfigs.get_smoke(ARCH)), f32(tconfigs.get_smoke(ARCH))
    if kind == "shared":
        cj, ct = dataclasses.replace(cj, **VARIANT), \
            dataclasses.replace(ct, **VARIANT)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


def _model(kind, seed=0, bpw=1.0):
    cj, ct = _configs(kind)
    tree = packed_model(ct, seed=seed, bpw=bpw)
    return cj, ct, tree, jax_tree(tree), torch_params(tree)


@pytest.fixture(scope="module", params=["smoke", "shared"])
def model(request):
    return _model(request.param)


def _tparams(tparams, mode):
    if MODES[mode][0].use_merged_projections("cpu"):
        return tsurgery.merge_projection_groups(tparams)
    return tparams


# ---------------------------------------------------------------------------
# the stacked-expert linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eff", [None, 32])
@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("mode", list(MODES))
def test_expert_matmul_matches_jax(mode, C, eff, dt, monkeypatch):
    """E = 8 experts, x per expert: ``ref`` against JAX's per-expert
    two-stage oracle; ``kernels`` (one launch of the grouped kernel with
    the expert axis as its group axis) against JAX's fused Pallas kernel
    in interpret mode; ``twocall`` (each expert through two packed_matmul
    launches) against JAX's two-call Pallas chain."""
    rng = np.random.default_rng(100 + C)
    E, K, R, N = 8, 64, 64, 96
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    qv = rng.integers(0, 2 ** 32, size=(E, K // 32, R), dtype=np.uint32)
    qu = rng.integers(0, 2 ** 32, size=(E, R // 32, N), dtype=np.uint32)
    s1 = (rng.standard_normal((E, N)) * 0.1 + 1 / np.sqrt(R)
          ).astype(np.float32)
    s2 = (rng.standard_normal((E, K)) * 0.1 + 1 / np.sqrt(K)
          ).astype(np.float32)
    ops_j = [pair(a) for a in (qv, qu, s1, s2)]
    jx, tx = pair(x, dt)
    tpol, jpol = MODES[mode]
    want = jops.lowrank_binary_matmul_expert(
        jx, *[a[0] for a in ops_j], policy=jpol, eff_rank=eff)
    calls = []
    real = binary_matmul.fused_lowrank_matmul_grouped
    monkeypatch.setattr(
        binary_matmul, "fused_lowrank_matmul_grouped",
        lambda *a, **k: calls.append((a[1].shape[0], k["x_shared"]))
        or real(*a, **k))
    got = ops.lowrank_binary_matmul_expert(
        tx, *[a[1] for a in ops_j], policy=tpol, eff_rank=eff)
    assert got.shape == (E, C, N) and got.dtype == tx.dtype
    assert_close(want, got, tol(dt), f"expert matmul {mode} C={C} "
                 f"eff={eff} {dt}")
    assert calls == ([(E, False)] if mode == "kernels" else [])


# ---------------------------------------------------------------------------
# the router and the moe layer
# ---------------------------------------------------------------------------


def test_route_matches_jax_and_breaks_ties_low():
    """Experts 2, 5 and 6 get equal logits, the largest of every token, at
    top-2: both packages pick 2 and 5, in that order."""
    cfg = f32(tconfigs.get_smoke(ARCH))
    rng = np.random.default_rng(11)
    d, E = cfg.d_model, cfg.n_experts
    x = np.abs(rng.standard_normal((40, d))).astype(np.float32)
    w = (rng.standard_normal((d, E)) * 0.1 / np.sqrt(d)).astype(np.float32)
    w[:, [2, 5, 6]] = 1.0 / np.sqrt(d)
    want = JL._route({"router": {"w": jnp.asarray(w)}}, cfg, jnp.asarray(x))
    got = TL._route({"router": {"w": torch.from_numpy(w)}}, cfg,
                    torch.from_numpy(x))
    assert got[1].tolist() == np.asarray(want[1]).tolist() == [[2, 5]] * 40
    # without ties too
    w = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    want = JL._route({"router": {"w": jnp.asarray(w)}}, cfg, jnp.asarray(x))
    got = TL._route({"router": {"w": torch.from_numpy(w)}}, cfg,
                    torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    for a, b in ((want[0], got[0]), (want[2], got[2])):
        assert_close(a, b, tol("f32"), "route weights")


def _moe_params(cfg, packed, seed=3):
    """Layer 0's ``moe`` dict of a seeded model, FP or packed (numpy)."""
    tmpl = tsurgery.abstract_quantized_params(cfg, 1.0, min_dim=16) \
        if packed else tsurgery.param_specs(cfg)
    tree = random_packed_params(tmpl, seed)["layers"]["moe"]

    def first(node):
        return {k: first(v) for k, v in node.items()} \
            if isinstance(node, dict) else np.ascontiguousarray(node[0])
    return first(tree)


def _moe_pair(kind, dt, packed):
    cj, ct = _configs(kind)
    tree = _moe_params(ct, packed)
    jp = jax_tree(tree)
    tp = params_from_numpy(tree, "cpu")
    if dt == "bf16":
        jp = cast_jax(jp, jnp.bfloat16)
        tp = params_from_numpy(tp, "cpu", torch.bfloat16)
    return cj, ct, jp, tp


def _moe_x(cfg, dt, seed=4):
    x = np.random.default_rng(seed).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    return pair(x, dt)


@pytest.mark.parametrize("capacity", [None, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["fp", "packed-ref", "packed-kernels",
                                  "shared-packed-ref"])
def test_moe_layer_matches_jax(kind, dt, capacity):
    """128 tokens, 8 experts, top-2: the default capacity is 40 rows per
    expert; 8 drops routed pairs, and the dropped pairs must drop in both
    packages alike."""
    packed = kind != "fp"
    mode = "kernels" if kind.endswith("kernels") else "ref"
    cj, ct, jp, tp = _moe_pair("shared" if kind.startswith("shared")
                               else "smoke", dt, packed)
    jx, tx = _moe_x(ct, dt)
    tpol, jpol = MODES[mode]
    with jops.kernel_policy(jpol):
        want = JL.moe(jp, cj, jx, capacity=capacity)
    with ops.kernel_policy(tpol):
        got = TL.moe(_tparams(tp, mode), ct, tx, capacity=capacity)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_close(want, got, tol(dt), f"moe {kind} {dt} capacity={capacity}")
    if capacity == 8:
        _, topi, _ = TL._route(tp, ct, tx.reshape(-1, ct.d_model))
        assert torch.bincount(topi.reshape(-1)).max() > capacity


def test_moe_capacity_drops_tokens():
    """The analogue of ``tests/test_models.py::
    test_moe_capacity_drops_tokens``: with a tight capacity some pairs
    overflow to the trash row and lose their expert's contribution, the
    output stays finite and bounded, and both packages drop alike."""
    cj, ct = _configs("smoke")
    cj, ct = (dataclasses.replace(c, capacity_factor=8.0) for c in (cj, ct))
    tree = _moe_params(ct, packed=False, seed=2)
    jp, tp = jax_tree(tree), params_from_numpy(tree, "cpu")
    jx, tx = _moe_x(ct, "f32", seed=3)
    full, tight = (TL.moe(tp, ct, tx, capacity=c) for c in (64, 8))
    assert torch.isfinite(tight).all()
    assert float(tight.abs().max()) <= float(full.abs().max()) * 4
    assert float((tight - full).abs().max()) > 1e-3
    for c, got in ((64, full), (8, tight)):
        assert_close(JL.moe(jp, cj, jx, capacity=c), got, tol("f32"),
                     f"moe capacity {c}")


@pytest.mark.parametrize("kind", ["smoke", "shared"])
def test_moe_matches_dense_oracle(kind):
    """At a capacity no expert overflows, the dispatch equals every expert
    on every token weighted by the router (the port's and JAX's oracle)."""
    cj, ct, jp, tp = _moe_pair(kind, "f32", packed=False)
    jx, tx = _moe_x(ct, "f32")
    got = TL.moe(tp, ct, tx, capacity=128)
    oracle = TL.moe_dense_oracle(tp, ct, tx)
    assert_close(oracle, got, tol("f32"), "moe vs its dense oracle")
    assert_close(JL.moe_dense_oracle(jp, cj, jx), oracle, tol("f32"),
                 "dense oracle vs JAX's")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_forward_matches_jax(model, mode):
    cj, _, _, jparams, tparams = model
    check_forward(cj, jparams, _tparams(tparams, mode), MODES[mode][0],
                  LOGITS_TOL, f"{cj.name} {mode}")


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_prefill_matches_jax(model, mode):
    cj, _, _, jparams, tparams = model
    check_prefill(cj, jparams, _tparams(tparams, mode), MODES[mode][0],
                  LOGITS_TOL, f"{cj.name} {mode}")


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_paged_decode_step_matches_jax(model, mode):
    """One pool per block stack (the variant's ``dense_layers`` have their
    own), read through the same tables."""
    cj, ct, _, jparams, tparams = model
    assert sorted(TT.stack_depths(ct)) == (
        ["dense_layers", "layers"] if ct.first_k_dense else ["layers"])
    check_paged_decode(cj, jparams, _tparams(tparams, mode), MODES[mode][0],
                       LOGITS_TOL, f"{cj.name} {mode}")


def test_merge_skips_the_expert_stacks(model):
    """Merged groups as JAX builds them: QKV and the shared expert's and
    dense blocks' gate-up, never the expert stacks (the router's dict)."""
    _, _, _, jparams, tparams = model
    merged = tsurgery.merge_projection_groups(tparams)
    jm = jax.tree_util.tree_flatten_with_path(
        jsurgery.merge_projection_groups(jparams))[0]
    tm = jax.tree_util.tree_flatten_with_path(merged)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jm] == \
        [jax.tree_util.keystr(k) for k, _ in tm]
    for (kp, a), (_, b) in zip(jm, tm):
        a = np.asarray(a)
        np.testing.assert_array_equal(
            a.view(np.int32) if a.dtype == np.uint32 else a, b.numpy(),
            err_msg=jax.tree_util.keystr(kp))
    moe = merged["layers"]["moe"]
    assert "wgu" not in moe and "wqkv" in merged["layers"]["attn"]
    if "shared" in moe:
        assert "wgu" in moe["shared"] and "wgu" in merged["dense_layers"]["ffn"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


LENS, BUDGETS = [3, 9, 17, 5, 12], [6, 3, 5, 8, 4]
PS = 8
SPEC_KEYS = ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_rollback_tokens", "spec_rollback_pages", "decode_steps",
             "tokens_emitted", "preemptions")
PREFIX_KEYS = ("prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
               "evicted_pages", "shared_pages", "preemptions")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's engine runs, each made once and shared by the port's modes:
    {key: (tokens, stats, admission steps)}."""
    return {}


def _port_engine(ct, tparams, mode, **kw):
    return InferenceEngine(tparams, ct, ServeConfig(greedy=True, page_size=PS,
                                                    debug=True, **kw),
                           max_batch=2, max_len=48, device="cpu",
                           policy=MODES[mode][0])


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_engine_matches_jax_engine(model, jax_runs, mode):
    """Plain decoding with mid-flight admission, no prefix cache."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS)
    want, jstats, jsteps = jax_engine(jax_runs, cj, jparams, prompts,
                                      BUDGETS, page_size=PS,
                                      prefix_cache=False)
    teng = _port_engine(ct, tparams, mode, prefix_cache=False)
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    assert teng.admission_step == jsteps
    assert teng.stats["decode_steps"] == jstats["decode_steps"]
    drained(teng)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_rect_engine_matches_jax_engine(model, jax_runs, mode):
    """The engine on the rectangular cache (``paged=False``; the variant's
    leading dense block has its own rectangle) against JAX's engine (its
    pool, whose tokens the reference holds equal to its rectangle's): the
    MoE decodes on the batch of both slots as JAX's does, so tokens,
    admission and decode steps equal; no pool, every layer's k / v
    rectangle of 2 slots x 48 rows."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS)
    want, jstats, jsteps = jax_engine(jax_runs, cj, jparams, prompts,
                                      BUDGETS, page_size=PS,
                                      prefix_cache=False)
    teng = _port_engine(ct, tparams, mode, paged=False)
    assert teng.kv is None
    assert set(teng.cache) == ({"dense_layers", "layers"}
                               if ct.first_k_dense else {"layers"})
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    assert teng.admission_step == jsteps
    assert teng.stats["decode_steps"] == jstats["decode_steps"]
    assert teng.kv_cache_bytes() == (ct.n_layers * 2 * 48 * 2
                                     * ct.n_kv_heads * ct.head_dim * 4)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_prefix_engine_matches_jax_engine(model, jax_runs, mode):
    """The prefix cache: hits prefill their suffix padded as JAX pads it,
    so tokens and counters equal JAX's prefix engine."""
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


def test_suffix_prefill_pads_like_jax(monkeypatch):
    """A hit's suffix prefill runs at JAX's bucketed length clamped to the
    slot's rows in the MoE family, and at its exact length in the dense
    family."""
    rows = []
    real = TT.prefill

    def spy(params, cfg, tokens, cache, **kw):
        if kw.get("start_pos") is not None:
            rows.append((cfg.family, int(kw["start_pos"][0]),
                         tokens.shape[1], kw.get("last_idx")))
        return real(params, cfg, tokens, cache, **kw)
    monkeypatch.setattr(TT, "prefill", spy)
    for arch in (ARCH, "llama3.2-1b"):
        cfg = f32(tconfigs.get_smoke(arch))
        eng = InferenceEngine(torch_params(packed_model(cfg, seed=0)), cfg,
                              ServeConfig(greedy=True, page_size=PS),
                              max_batch=1, max_len=40, device="cpu")
        base = draw_prompts(cfg, [2 * PS + 3], seed=5)[0]
        # 19 tokens, then the same 19: a 2-page hit and a 3-token suffix,
        # bucket 8; then the 2 pages and 17 more: bucket 32, clamped to
        # the slot's 40 rows less the 16 shared
        for uid, p in enumerate((base, base, np.concatenate(
                [base[:2 * PS], draw_prompts(cfg, [17], seed=6)[0]]))):
            eng.submit(Request(uid, p, max_new_tokens=2))
            eng.run()
    assert rows == [("moe", 2 * PS, 8, 2), ("moe", 2 * PS, 24, 16),
                    ("dense", 2 * PS, 3, 2), ("dense", 2 * PS, 17, 16)]


@pytest.fixture(scope="module")
def spec_model():
    """The smoke model packed at 6 bpw, so that its ranks truncate."""
    return _model("smoke", bpw=6.0)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_spec_engine_matches_jax_engine(spec_model, jax_runs, mode):
    """Self-speculative decoding (half-rank draft, k = 4): tokens equal
    JAX's ``SpecDecodeController`` engine's (the verify runs B·(k+1)
    rows, so it is not gated against plain decoding); in the unmerged
    layout the spec counters equal JAX's too. The draft's truncated
    expert stacks go through the kernel's ``eff_rank``."""
    cj, ct, _, jparams, tparams = spec_model
    kw = dict(prefix_cache=False, spec_rank_frac=0.5, spec_k=4)
    prompts = draw_prompts(ct, LENS)
    want, jstats, _ = jax_engine(jax_runs, cj, jparams, prompts, BUDGETS,
                                 page_size=PS, **kw)
    teng = _port_engine(ct, tparams, mode, **kw)
    moe = teng.spec.draft_params["layers"][0]["moe"]
    assert moe["w_gate"]["eff_rank"] < moe["w_gate"]["qv"].shape[-1]
    same_tokens(want, serve_engine(teng, Request, prompts, BUDGETS))
    st = {k: teng.stats[k] for k in SPEC_KEYS}
    assert st["spec_cycles"] > 0 and st["spec_rollback_tokens"] > 0
    if mode == "ref":
        assert st == {k: jstats[k] for k in SPEC_KEYS}
    drained(teng)


# ---------------------------------------------------------------------------
# artifacts and dtypes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifacts_cross_the_packages(tmp_path, dtype):
    """A JAX-saved MoE artifact (router f32 in a bf16 model, as JAX keeps
    it) loads leaf for leaf in the port, and the port's ``save`` of it
    loads leaf for leaf in JAX."""
    cj, ct = (dataclasses.replace(c, **VARIANT, dtype=dtype)
              for c in _configs("smoke"))
    tree = packed_model(ct, seed=5)
    jparams = jax_tree(tree)
    if dtype == "bfloat16":
        jparams = cast_jax(jparams, jnp.bfloat16)
    qcfg = japi.QuantConfig(target_bpw=1.0, min_dim=16)
    japi.NanoQuantModel(jparams, cj, qcfg, {"ranks": {}}).save(
        str(tmp_path / "jax"))
    m = NanoQuantModel.load(str(tmp_path / "jax"), device="cpu")
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(cj)
    leaves_equal(jparams, m.params)
    assert m.params["layers"]["moe"]["router"]["w"].dtype == torch.float32
    m.save(str(tmp_path / "port"))
    back = japi.NanoQuantModel.load(str(tmp_path / "port"))
    leaves_equal(jparams, back.params)


def test_router_stays_f32_in_a_bf16_model():
    """Cast to bf16, every FP leaf is bf16 but the router (JAX's
    ``init_moe``: "router stays FP32"); the template says so too, and the
    bf16 model's routing runs in f32 and matches JAX's bf16 model."""
    cj, ct = _configs("shared")
    tree = packed_model(ct, seed=7)
    m = NanoQuantModel.from_numpy(tree, dataclasses.replace(
        ct, dtype="bfloat16"), device="cpu", dtype=torch.bfloat16)
    lp = m.params["layers"]
    assert lp["moe"]["router"]["w"].dtype == torch.float32
    assert lp["moe"]["shared"]["w_gate"]["s1"].dtype == torch.float32
    assert lp["ln1"].dtype == lp["attn"]["q_norm"].dtype == \
        m.params["dense_layers"]["ln2"].dtype == torch.bfloat16
    tmpl = tsurgery.param_specs(m.cfg)
    assert tmpl["layers"]["moe"]["router"]["w"].dtype == "float32"
    assert tmpl["layers"]["moe"]["w_gate"]["w"].dtype == "bfloat16"
    cjb = dataclasses.replace(cj, dtype="bfloat16")
    jparams = cast_jax(jax_tree(tree), jnp.bfloat16)
    check_forward(cjb, jparams, m.params, MODES["ref"][0], tol("bf16"),
                  "bf16 moe")


@pytest.mark.parametrize("arch", sorted(jconfigs.list_archs()))
def test_every_jax_arch_is_served(arch):
    """Every arch of the JAX package is registered in the port with the same
    full-size and smoke configs, ``check_family`` admits it, its cache has
    page kinds (none for the SSM family), and the port's FP template equals
    JAX's ``param_specs`` leaf for leaf (shapes only, at full size)."""
    for get in ("get_config", "get_smoke"):
        cj = getattr(jconfigs, get)(arch)
        ct = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        check_family(ct)
        assert paging.cache_page_kinds(ct) <= {"linear", "ring"}
    want, got = flat_templates(
        jshapes.param_specs(jconfigs.get_config(arch)),
        tsurgery.param_specs(tconfigs.get_config(arch)))
    assert want == got
