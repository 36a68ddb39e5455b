"""Tensor-parallel serving of the audio and MoE families in the port
(``InferenceEngine(mesh=)`` for musicgen-medium, qwen3-moe-235b-a22b and
deepseek-v2-lite-16b's MLA) against the JAX package, on the CPU.

- ``place_on_mesh`` against JAX's specs for these families is
  ``tests/test_torch_sharding.py::test_place_on_mesh_cuts_by_jax_specs``.
- One spawn of two gloo ranks (``tests/_torch_tp_ranks.py::
  family_checks``) runs #1's expert launch on each rank's E / N stack
  (fused, two-call, ref) against JAX's oracle vmapped over the whole
  stack at f32 1e-5, the audio family's vocab-parallel embedding against
  the whole tables, and the TP engines of the three smoke configs in f32
  against JAX's *unsharded* engine, paged and on the rectangle
  (``paged=False``), qwen3-moe also with the prefix cache and
  self-speculative. The JAX runs are made in this process while the
  ranks run.
- deepseek's smoke config packs its shared experts' and dense layer's
  w_down at 3 and 5 words of d_in, which do not split over two ranks;
  its engine runs on a variant (moe_d_ff 128, dense_d_ff 192, both
  packages), and the smoke config itself is refused.
- ``launch.serve --tp 2 --tp-backend gloo`` serves a qwen3-moe artifact.
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
                           packed_model, shared_prompts, tol)
from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro_torch.api import NanoQuantModel
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.serve.engine import InferenceEngine, check_tp_layout

ARCHS = {"qwen": "qwen3-moe-235b-a22b", "deepseek": "deepseek-v2-lite-16b",
         "musicgen": "musicgen-medium"}
# deepseek's packed shared-expert and dense w_down split into whole words
DEEPSEEK_TP = dict(moe_d_ff=128, dense_d_ff=192)
MIN_DIM = {"qwen": 16, "deepseek": 8, "musicgen": 16}
LENS, BUDGETS = [3, 9, 17, 5, 12], [6, 3, 5, 8, 4]
PS = 8


def _configs(key):
    """(JAX config, port config) of one family's f32 smoke model."""
    cj = f32(jconfigs.get_smoke(ARCHS[key]))
    ct = f32(get_smoke(ARCHS[key]))
    if key == "deepseek":
        cj = dataclasses.replace(cj, **DEEPSEEK_TP)
        ct = dataclasses.replace(ct, **DEEPSEEK_TP)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


def _prompts(key, ct, lens, seed=0):
    if key != "musicgen":
        return draw_prompts(ct, lens, seed)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, ct.vocab_size, size=(n, ct.n_codebooks))
            .astype(np.int32) for n in lens]


def _mesh(rank=0, n=2):
    """The port's mesh of one rank without a process group."""
    return tmesh.Mesh(("data", "model"), (1, n), {"data": 0, "model": rank},
                      None, torch.device("cpu"), "gloo")


def _expert_case(rng, E=8, K=64, N=96, R=64, C=8):
    """One packed expert stack (E experts, K -> N at rank R) with a layer
    axis, as the rules see a stacked tree, and a dispatch buffer."""
    words = lambda *s: rng.integers(0, 2 ** 32, s, dtype=np.uint32)  # noqa
    lin = {"qv": words(1, E, K // 32, R), "qu_t": words(1, E, R // 32, N),
           "s1": rng.uniform(0.5, 1.5, (1, E, N)).astype(np.float32),
           "s2": rng.uniform(0.5, 1.5, (1, E, K)).astype(np.float32)}
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    return {"layers": {"moe": {"w_gate": lin}}}, x


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    out = {"budgets": BUDGETS}
    for key in ARCHS:
        cj, ct = _configs(key)
        out[key] = packed_model(ct, 0, min_dim=MIN_DIM[key])
        out[f"{key}_cfg"], out[f"{key}_jcfg"] = ct, cj
        out[f"{key}_prompts"] = _prompts(key, ct, LENS)
    # packed at 6 bpw so the draft's rank truncation has room
    out["qwen_spec"] = packed_model(out["qwen_cfg"], 0, bpw=6.0)
    out["shared_prompts"], out["shared_budgets"] = shared_prompts(
        out["qwen_cfg"], PS)
    out["experts"], out["expert_x"] = _expert_case(rng)
    mcfg = out["musicgen_cfg"]
    out["frames"] = rng.integers(0, mcfg.vocab_size,
                                 (2, 5, mcfg.n_codebooks)).astype(np.int64)
    return out


def _jax_runs(case):
    """JAX's unsharded engines on the traces, each run once (plain,
    prefix and speculative qwen3-moe; deepseek on its rectangle, the
    reference's identity oracle for MLA; musicgen)."""
    runs = {}

    def run(key, tree, prompts, budgets, **kw):
        jparams = runs.setdefault(("tree", key, id(tree)), jax_tree(tree))
        toks, stats, _ = jax_engine(runs, case[f"{key}_jcfg"], jparams,
                                    prompts, budgets, page_size=PS, **kw)
        return {u: np.asarray(t).tolist() for u, t in toks.items()}, stats
    return {
        "qwen": run("qwen", case["qwen"], case["qwen_prompts"], BUDGETS,
                    prefix_cache=False),
        "qwen_prefix": run("qwen", case["qwen"], case["shared_prompts"],
                           case["shared_budgets"]),
        "qwen_spec": run("qwen", case["qwen_spec"], case["qwen_prompts"],
                         BUDGETS, prefix_cache=False, spec_rank_frac=0.5,
                         spec_k=4),
        "deepseek": run("deepseek", case["deepseek"],
                        case["deepseek_prompts"], BUDGETS, paged=False),
        "musicgen": run("musicgen", case["musicgen"],
                        case["musicgen_prompts"], BUDGETS,
                        prefix_cache=False)}


@pytest.fixture(scope="module")
def results(case, tmp_path_factory):
    """(the ranks' results, JAX's runs): the two gloo ranks run in their
    own processes while JAX's engines run here."""
    got = {}

    def ranks():
        try:
            got["ranks"] = tmesh.run_ranks(
                R.family_checks, R.TP, "gloo", args=(case,),
                workdir=str(tmp_path_factory.mktemp("tpf")), threads=1)
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


@pytest.mark.parametrize("route", ["fused", "twocall", "ref"])
def test_expert_launch_rank_local_matches_jax(case, results, route):
    """#1 on each rank's block of E / 2 experts, x its slice of the
    dispatch buffer, concatenated in rank order, equals JAX's oracle
    vmapped over the whole stack (f32, 1e-5)."""
    ranks, _ = results
    lin = {k: v[0] for k, v in case["experts"]["layers"]["moe"]
           ["w_gate"].items()}
    want = np.asarray(jax.vmap(jref.lowrank_binary_matmul_ref)(
        case["expert_x"], lin["qv"], lin["qu_t"], lin["s1"], lin["s2"]))
    E = want.shape[0]
    assert [r["experts"]["range"] for r in ranks.values()] == \
        [(0, E // 2), (E // 2, E // 2)]
    got = np.concatenate([ranks[r]["experts"][route] for r in range(2)])
    assert_close(want, got, tol("f32"), f"expert launch {route}")


def test_audio_embedding_vocab_parallel_is_exact(results, case):
    """The audio family's (K, V / 2, d) shard per rank: the per-codebook
    rows all-reduced, then summed in codebook order, equal the whole
    tables' embedding bit for bit."""
    ranks, _ = results
    cfg = case["musicgen_cfg"]
    for r in ranks.values():
        local, full, shape = r["embed"]
        assert shape == (cfg.n_codebooks, cfg.vocab_size // 2, cfg.d_model)
        np.testing.assert_array_equal(local, full)


@pytest.mark.parametrize("layout", ["paged", "rect"])
@pytest.mark.parametrize("key", list(ARCHS))
def test_tp_engine_tokens_equal_unsharded_jax(results, case, key, layout):
    """Every rank's greedy tokens equal JAX's unsharded engine's, on the
    pool and on the rectangle; the pool drained."""
    ranks, jax_runs = results
    want, _ = jax_runs[key]
    for r in ranks.values():
        res = r[f"{key}_{layout}"]
        assert res["tokens"] == want
        assert res["drained"]
    cfg = case[f"{key}_cfg"]
    cache = ranks[0][f"{key}_{layout}"]["cache"]["layers"]
    if cfg.is_mla:
        # the latent pool / rectangle whole on every rank
        assert cache["c_kv"][-1] == cfg.kv_lora_rank
        assert cache["k_rope"][-2:] == (1, cfg.qk_rope_dim)
    else:
        assert cache["k"][-2:] == (cfg.n_kv_heads // 2, cfg.head_dim)
    if layout == "rect":
        assert ranks[0][f"{key}_rect"]["kv_bytes"] == \
            ranks[1][f"{key}_rect"]["kv_bytes"]


def test_tp_moe_prefix_engine_matches_jax(results):
    """qwen3-moe with the prefix cache: a hit's suffix prefill is padded
    as JAX pads it, so tokens and counters equal JAX's prefix engine's on
    every rank."""
    ranks, jax_runs = results
    want, jstats = jax_runs["qwen_prefix"]
    for r in ranks.values():
        res = r["qwen_prefix"]
        assert res["tokens"] == want and res["drained"]
        for k in ("prefix_hit_tokens", "cow_copies", "shared_pages"):
            assert res["stats"][k] == jstats[k] > 0, k


def test_tp_moe_spec_engine_matches_jax(results):
    """qwen3-moe self-speculative (half-rank draft, k = 4): the verify's
    B·(k+1) rows set the capacity as in the unsharded engine; tokens and
    spec counters equal JAX's on every rank."""
    ranks, jax_runs = results
    want, jstats = jax_runs["qwen_spec"]
    for r in ranks.values():
        res = r["qwen_spec"]
        assert res["tokens"] == want
        for k in ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
                  "spec_rollback_tokens"):
            assert res["stats"][k] == jstats[k], k
    assert jstats["spec_rollback_tokens"] > 0


@pytest.mark.parametrize("key", list(ARCHS))
def test_tp_collectives_and_expert_grid_per_forward(results, case, key):
    """Per forward (an admission's prefill or a decode step): 2 × layers
    + 1 all-reduces (wo, and the FFN's w_down or the MoE layer's one,
    which also carries the shared experts' partial, per layer; the
    embedding's), one all-gather of the logits; each MoE layer's three
    expert linears are #1 at the rank-local grid (G = E / 2)."""
    ranks, _ = results
    cfg = case[f"{key}_cfg"]
    for r in ranks.values():
        res = r[f"{key}_paged"]
        st, c = res["stats"], res["comm"]
        forwards = st["admissions"] + st["decode_steps"]
        assert c["all_reduce"] == (2 * cfg.n_layers + 1) * forwards
        assert c["all_gather"] == forwards
        experts = [g for g, shared in res["grids"] if not shared]
        if cfg.family == "moe":
            n_moe = cfg.n_layers - cfg.first_k_dense
            assert experts == [cfg.n_experts // 2] * (3 * n_moe * forwards)
        else:
            assert experts == []


@pytest.mark.parametrize("key", ["qwen", "deepseek"])
def test_tp_ranks_route_identically(results, key):
    """Every router call chose the same experts on both ranks, in every
    MoE run (a rank that routed otherwise would sum mismatched
    partials)."""
    ranks, _ = results
    runs = [k for k in ranks[0] if k.startswith(key + "_")]
    assert runs
    for run in runs:
        a, b = ranks[0][run]["routes"], ranks[1][run]["routes"]
        assert len(a) == len(b) > 0, run
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=run)


# ---------------------------------------------------------------------------
# the layout checks and the CLI
# ---------------------------------------------------------------------------


def test_check_tp_layout_holds_experts_to_the_expert_axis(case):
    """``check_tp_layout`` accepts the E-split of the routed stacks (whose
    w_down is row-parallel by name), refuses experts that do not divide
    the ranks, and refuses deepseek's smoke config, whose packed shared
    w_down (3 words of d_in) does not split."""
    params = R.params_from_numpy(case["qwen"], "cpu")
    cfg = case["qwen_cfg"]
    for rank in (0, 1):
        check_tp_layout(cfg, params, _mesh(rank))
    with pytest.raises(NotImplementedError, match="experts do not divide"):
        InferenceEngine({"embed": torch.zeros(1)},
                        dataclasses.replace(cfg, n_experts=6), device="cpu",
                        mesh=_mesh(0, 4))
    # the rules leave a stack of 7 experts whole over two ranks, which
    # the expert launch cannot read
    odd = dataclasses.replace(cfg, n_experts=7)
    with pytest.raises(NotImplementedError, match="expert axis only"):
        check_tp_layout(odd, R.params_from_numpy(packed_model(odd, 0),
                                                 "cpu"), _mesh())
    smoke = f32(get_smoke(ARCHS["deepseek"]))
    with pytest.raises(NotImplementedError, match="split on its d_in"):
        InferenceEngine(R.params_from_numpy(packed_model(smoke, 0, min_dim=8),
                                            "cpu"), smoke, device="cpu",
                        mesh=_mesh())


def test_launch_serve_tp_moe_artifact(case, tmp_path, monkeypatch):
    """``launch.serve --quantized-ckpt DIR --tp 2 --tp-backend gloo`` on a
    qwen3-moe artifact serves every request, and its tokens (sampled from
    the seed) equal the unsharded CLI's."""
    from repro_torch.launch import serve
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    art = NanoQuantModel.from_numpy(
        case["qwen"], case["qwen_cfg"], device="cpu",
        quant={"target_bpw": 1.0, "min_dim": MIN_DIM["qwen"]}).save(
            str(tmp_path / "nq"))
    argv = ["--device", "cpu", "--quantized-ckpt", art, "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-batch", "2"]
    want = serve.main(argv)
    got = serve.main(argv + ["--tp", "2", "--tp-backend", "gloo"])
    assert sorted(got) == [0, 1, 2] and all(len(t) == 4
                                            for t in got.values())
    assert {u: t.tolist() for u, t in got.items()} == \
        {u: t.tolist() for u, t in want.items()}
