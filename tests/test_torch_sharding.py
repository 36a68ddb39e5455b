"""Tensor-parallel serving of the port (``repro_torch.sharding``,
``launch.mesh``, ``place_on_mesh`` and ``InferenceEngine(mesh=)``)
against the JAX package, on the CPU.

- The rule table: ``param_pspecs``, ``cache_pspecs`` (paged and
  rectangular) and ``batch_pspecs`` equal JAX's spec for spec, for every
  arch's FP and 1.0-bpw templates under ``DEFAULT`` and ``SERVE`` on
  abstract meshes (1, 2), (1, 4), (1, 8), (2, 2) and (2, 2, 2).
- ``place_on_mesh``: each rank's shards equal the full arrays cut by JAX's
  spec (the dense, MoE, MLA and audio smoke configs), but for the
  recorded departure (wk / wv whole where the kv heads do not divide the
  model axis).
- One spawn of two gloo ranks (``tests/_torch_tp_ranks.py``) runs the
  column, row and merged launches (fused, and the two-call route with
  ``MAX_FUSED_RANK`` lowered) against JAX's oracle at f32 1e-5, the
  head-local paged attention against JAX's, and the TP engine against
  JAX's *unsharded* engine: greedy tokens on the reference's TP config
  (d 64, 4 heads, 2 kv heads, f32; ``tests/test_engine.py``'s sharded
  engine) plain and with the prefix cache, self-speculative with JAX's
  spec counters, and qwen1.5-110b's smoke config (1 kv head: wk / wv and
  the pool whole on each rank). The JAX references run in this process,
  shared through module fixtures.
- A second spawn: ``launch.serve --tp 2 --tp-backend gloo``.
- The refusals, and the api names this slice adds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import _torch_tp_ranks as R
from _torch_common import (assert_close, draw_prompts, f32, jax_engine,
                           jax_tree, one_torch_thread,  # noqa: F401
                           packed_model, shared_prompts, tol)
from repro import api as japi
from repro import configs as jconfigs
from repro.configs.shapes import param_specs as jparam_specs
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro.serve import paging as jpaging
from repro.sharding import rules as jrules
from repro_torch import api as tapi
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging as tpaging
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.scheduler import Request
from repro_torch.sharding import rules as trules

MESHES = (((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 8), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")))
POLICIES = (("DEFAULT", jrules.DEFAULT, trules.DEFAULT),
            ("SERVE", jrules.SERVE, trules.SERVE))
ARCHS = jconfigs.list_archs()
DENSE = ("llama3.2-1b", "qwen1.5-110b", "qwen3-4b")
# the families tensor-parallel serving places (the MoE's experts cut on E,
# MLA's w_uk / w_uv by head, the audio tables on V, a Mamba2 mixer by SSD
# head, the VLM's self and cross layers and the hybrid's shared block by
# attention head)
PLACED = DENSE + ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
                  "musicgen-medium", "mamba2-370m", "zamba2-1.2b",
                  "llama-3.2-vision-90b")


def _jspecs(tree) -> dict:
    """{path: spec tuple} of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jrules._path_str(kp): tuple(s) for kp, s in flat}


def _tspecs(tree, path="") -> dict:
    """{path: spec tuple} of a port spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tspecs(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: tree}


def _mesh(rank_coords=None, shape=(1, 2), names=("data", "model")):
    """The port's mesh of one rank without a process group (placement
    and the refusals need none)."""
    coords = rank_coords or {a: 0 for a in names}
    return tmesh.Mesh(names, shape, coords, None, torch.device("cpu"),
                      "gloo")


# ---------------------------------------------------------------------------
# (a) the rule table, spec for spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_batch_pspecs_match_jax(arch):
    cfg = get_config(arch)
    templates = (
        ("fp", jparam_specs(cfg), tsurgery.param_specs(cfg)),
        ("1.0 bpw", jsurgery.abstract_quantized_params(cfg, 1.0),
         tsurgery.abstract_quantized_params(cfg, 1.0)))
    batches = ((1, {"tokens": jax.ShapeDtypeStruct((8, 32), np.int32),
                    "labels": jax.ShapeDtypeStruct((8, 32), np.int32)}),
               (2, {"tokens": jax.ShapeDtypeStruct((2, 8, 32), np.int32),
                    "scalar": jax.ShapeDtypeStruct((), np.float32)}))
    for shape, names in MESHES:
        m = AbstractMesh(shape, names)
        for kind, jt, tt in templates:
            for pname, jp, tp in POLICIES:
                want = _jspecs(jrules.param_pspecs(cfg, jt, m, jp))
                got = _tspecs(trules.param_pspecs(cfg, tt, m, tp))
                assert got == want, (arch, kind, pname, shape)
        for accum, batch in batches:
            assert _tspecs(trules.batch_pspecs(cfg, batch, m, accum)) == \
                _jspecs(jrules.batch_pspecs(cfg, batch, m, accum))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_jax(arch):
    """The rectangular cache (B 4, 128 rows) and the paged pool (16 pages
    of 64) of every arch at its published width: every leaf the port's
    cache has gets JAX's spec (the port's trees hold no leaf JAX's lack;
    JAX's hybrid cache also has its ring length, a value leaf)."""
    cfg = get_config(arch)
    caches = [(False, jax.eval_shape(lambda: JT.init_cache(cfg, 4, 128)),
               TT.init_cache(cfg, 4, 128, device="meta"))]
    if tpaging.cache_page_kinds(cfg):
        caches.append((True, jax.eval_shape(
            lambda: jpaging.init_paged_cache(cfg, 4, 128, 16, 64)),
            tpaging.init_paged_cache(cfg, 16, 64, device="meta", batch=4)))
    for shape, names in MESHES:
        m = AbstractMesh(shape, names)
        for paged, jc, tc in caches:
            for pname, jp, tp in POLICIES:
                want = _jspecs(jrules.cache_pspecs(cfg, jc, m, jp, paged))
                got = _tspecs(trules.cache_pspecs(cfg, tc, m, tp, paged))
                assert got and set(got) <= set(want), (arch, paged)
                assert got == {k: want[k] for k in got}, (arch, paged, shape)


def test_local_shard_cuts_blocks_row_major():
    """A dim split over two axes is cut row-major, outermost first, as
    JAX lays devices out; local_shape is the block's shape."""
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    m = _mesh({"pod": 1, "data": 0, "model": 2}, (2, 2, 3),
              ("pod", "data", "model"))
    got = trules.local_shard(t, spec, m, m.coords)
    assert torch.equal(got, t[4:6, 4:6])
    assert trules.local_shape(t.shape, spec, m) == (2, 2)
    assert trules.local_shard(t, (None, None), m, m.coords) is t
    # a block of the leading dim is a copy of its own, not a view that
    # would keep the whole tensor alive
    lead = trules.local_shard(t, ("model", None), m, m.coords)
    assert torch.equal(lead, t[4:6])
    assert lead.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# (b) place_on_mesh against JAX's specs
# ---------------------------------------------------------------------------


def _cut(a: np.ndarray, spec, mesh_shape, coords) -> np.ndarray:
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n, idx = 1, 0
        for ax in axes:
            n, idx = n * mesh_shape[ax], idx * mesh_shape[ax] + coords[ax]
        if n > 1:
            size = a.shape[dim] // n
            a = np.take(a, range(idx * size, (idx + 1) * size), axis=dim)
    return a


def _np(t) -> np.ndarray:
    return t.numpy() if t.dtype != torch.bfloat16 else t.float().numpy()


@pytest.mark.parametrize("arch", PLACED)
@pytest.mark.parametrize("kind", ["fp", "packed"])
def test_place_on_mesh_cuts_by_jax_specs(arch, kind):
    cfg = f32(get_smoke(arch))
    if kind == "packed":
        tree = packed_model(cfg, 3, min_dim=8)
    else:
        tree = _unflat(_flat_np(TT.init_params(
            cfg, torch.Generator().manual_seed(3), "cpu")))
    for shape, names in MESHES[:2]:
        jm = AbstractMesh(shape, names)
        want_specs = _jspecs(jrules.param_pspecs(cfg, jax_tree(tree), jm,
                                                 jrules.SERVE))
        kv_whole = cfg.n_kv_heads % shape[-1] != 0
        full = _flat_np(tree)
        for r in range(shape[-1]):
            coords = {"data": 0, "model": r}
            got = _flat_np(tsurgery.place_on_mesh(
                R.params_from_numpy(tree, "cpu"), cfg,
                _mesh(coords, shape, names)))
            assert set(got) == set(full)
            for path, a in full.items():
                spec = want_specs[path]
                if kv_whole and path.split("/")[-2:-1] in (["wk"], ["wv"]):
                    spec = (None,) * a.ndim           # the departure
                want = _cut(a, spec, dict(zip(names, shape)), coords)
                np.testing.assert_array_equal(
                    got[path], want.view(got[path].dtype)
                    if want.dtype == np.uint32 else want, err_msg=path)


def _flat_np(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: _np(tree) if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def test_place_cache_on_mesh_and_local_pool():
    """place_cache_on_mesh cuts a pool by cache_pspecs(paged=True); the
    engine's pool (init_paged_cache(mesh=)) has that block's shape."""
    cfg = R.TP_CFG
    full = tpaging.init_paged_cache(cfg, 6, 8, device="cpu")
    full["layers"]["k"].copy_(torch.arange(full["layers"]["k"].numel())
                              .reshape(full["layers"]["k"].shape))
    m = _mesh({"data": 0, "model": 1})
    got = tsurgery.place_cache_on_mesh(full, cfg, m, paged=True)
    assert torch.equal(got["layers"]["k"], full["layers"]["k"][..., 1:, :])
    local = tpaging.init_paged_cache(cfg, 6, 8, device="cpu", mesh=m)
    assert local["layers"]["k"].shape == got["layers"]["k"].shape


@pytest.mark.parametrize("heads,kv,n,want", [
    (4, 2, 2, [(False, None)] * 2),            # kv heads split with q heads
    (8, 1, 2, [(True, slice(0, 1))] * 2),      # qwen1.5-110b smoke: 1 kv
    (8, 2, 4, [(True, slice(0, 1))] * 2 + [(True, slice(1, 2))] * 2),
    (6, 3, 2, None)])                          # 3 q heads straddle groups of 2
def test_kv_layout_places_params_and_caches_alike(heads, kv, n, want):
    """One decision (``surgery.kv_layout``) holds wk / wv, the pool and the
    rectangular prefill cache whole or split together, and says which kv
    head each rank's query heads read; the engine refuses a straddle."""
    cfg = dataclasses.replace(R.TP_CFG, n_heads=heads, n_kv_heads=kv,
                              head_dim=16)
    meshes = [_mesh({"data": 0, "model": r}, (1, n)) for r in range(n)]
    if want is None:
        with pytest.raises(NotImplementedError, match="GQA groups"):
            tsurgery.kv_layout(cfg, meshes[0])
        with pytest.raises(NotImplementedError, match="GQA groups"):
            InferenceEngine({"embed": torch.zeros(1)}, cfg, device="cpu",
                            mesh=meshes[0])
        return
    params = R.params_from_numpy(packed_model(cfg, 0, min_dim=16), "cpu")
    full = tpaging.init_paged_cache(cfg, 3, 8, device="cpu")
    for m, (whole, read) in zip(meshes, want):
        assert tsurgery.kv_layout(cfg, m) == (whole, read)
        local = tsurgery.place_on_mesh(params, cfg, m)["layers"]["attn"]
        hkv = kv if whole else kv // n
        assert local["wk"]["qu_t"].shape[-1] == hkv * cfg.head_dim
        pool = tpaging.init_paged_cache(cfg, 3, 8, device="cpu", mesh=m)
        assert pool["layers"]["k"].shape == tsurgery.place_cache_on_mesh(
            full, cfg, m, paged=True)["layers"]["k"].shape
        assert pool["layers"]["k"].shape[-2] == hkv
        rect = tsurgery.local_cache(
            lambda d: TT.init_cache(cfg, 1, 16, d), cfg, m, "cpu")
        assert rect["layers"]["v"].shape[-2] == hkv


# ---------------------------------------------------------------------------
# (c) two gloo ranks: launches, attention and engines against JAX
# ---------------------------------------------------------------------------


def _linears(rng):
    """A layer's packed wq (128 -> 256), wo (128 -> 96) and gate / up (128
    -> 192, ranks 96 and 64: a ragged merged group), as numpy."""
    def lin(k, n, r):
        return {"qv": rng.integers(0, 2 ** 32, (k // 32, r), dtype=np.uint32),
                "qu_t": rng.integers(0, 2 ** 32, (r // 32, n),
                                     dtype=np.uint32),
                "s1": rng.uniform(0.5, 1.5, n).astype(np.float32),
                "s2": rng.uniform(0.5, 1.5, k).astype(np.float32)}
    return {"layers": {"wq": lin(128, 256, 64), "wo": lin(128, 96, 64),
                       "w_gate": lin(128, 192, 96),
                       "w_up": lin(128, 192, 64)}}


def _paged_case(rng):
    B, ps, pages, Hq, Hkv, D = 3, 8, 4, 8, 4, 16
    q_pos = np.asarray([5, 17, 30], np.int32)
    bt = np.zeros((B, pages), np.int32)
    nxt = 1
    for b in range(B):
        for j in range(q_pos[b] // ps + 1):
            bt[b, j], nxt = nxt, nxt + 1
    pool = (nxt, ps, Hkv, D)
    return {"q": rng.standard_normal((B, 1, Hq, D)).astype(np.float32),
            "k": rng.standard_normal(pool).astype(np.float32),
            "v": rng.standard_normal(pool).astype(np.float32),
            "bt": bt, "q_pos": q_pos}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    prompts, budgets = shared_prompts(R.TP_CFG, 8)
    qcfg = f32(get_smoke("qwen1.5-110b"))
    return {"linears": _linears(rng), "lin_cfg": R.TP_CFG,
            "x": rng.standard_normal((5, 128)).astype(np.float32),
            "paged": _paged_case(rng),
            # packed at 6 bpw so the draft's rank truncation has room
            "tiny": packed_model(R.TP_CFG, 0, min_dim=32, bpw=6.0),
            "prompts": prompts, "budgets": budgets,
            "qwen": packed_model(qcfg, 1, min_dim=8, bpw=3.0),
            "qwen_cfg": qcfg,
            "qwen_prompts": draw_prompts(qcfg, [5, 11, 3, 8]),
            "cli_argv": ["--device", "cpu", "--rect", "--tp", "2",
                         "--tp-backend", "gloo", "--requests", "3",
                         "--prompt-len", "6", "--max-new", "4",
                         "--max-batch", "2"]}


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return tmesh.run_ranks(R.rank_checks, R.TP, "gloo", args=(case,),
                           workdir=str(tmp_path_factory.mktemp("tp")),
                           threads=1)


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(runs, case, which, **kw):
    """JAX's unsharded engine on `which` model's prompts, each run made
    once per module (``jax_engine`` keys its runs by the params' id, so
    the JAX tree is made once too)."""
    cfg = case["qwen_cfg"] if which == "qwen" else R.TP_CFG
    prompts = case["qwen_prompts"] if which == "qwen" else case["prompts"]
    budgets = case["budgets"][:len(prompts)]
    jparams = runs.setdefault(("tree", which), jax_tree(case[which]))
    toks, stats, _ = jax_engine(runs, cfg, jparams, prompts, budgets,
                                page_size=8, **kw)
    return {u: list(map(int, t)) for u, t in toks.items()}, stats


def test_tp_launches_match_jax_oracle(case, ranks):
    """Column (gathered), row (all-reduced) and merged launches on the
    ranks' shards, fused and two-call, equal JAX's oracle on the full
    operands, and every rank holds the same result."""
    lin = case["linears"]["layers"]
    x = case["x"]
    want = {name: np.asarray(jref.lowrank_binary_matmul_ref(
        x, lin[key]["qv"], lin[key]["qu_t"], lin[key]["s1"], lin[key]["s2"]))
        for name, key in (("col", "wq"), ("row", "wo"), ("gate", "w_gate"),
                          ("up", "w_up"))}
    for route in ("fused", "twocall"):
        for name in want:
            a, b = ranks[0][route][name], ranks[1][route][name]
            np.testing.assert_array_equal(a, b)
            assert_close(want[name], a, tol("f32"), f"{route} {name}")


def test_tp_paged_attention_head_local(case, ranks):
    pa = case["paged"]
    want = np.asarray(jref.paged_attention_ref(
        pa["q"], pa["k"], pa["v"], pa["bt"], pa["q_pos"], pa["q_pos"],
        scale=0.25))
    np.testing.assert_array_equal(ranks[0]["paged"], ranks[1]["paged"])
    assert_close(want, ranks[0]["paged"], tol("f32"), "head-local paged")


@pytest.mark.parametrize("run", ["plain", "prefix", "rect"])
def test_tp_engine_tokens_equal_unsharded_jax(case, ranks, jax_runs, run):
    """The TP engine's tokens on every rank equal JAX's unsharded engine's:
    plain, with the prefix cache, and on the rectangle (``paged=False``),
    whose rows, like the pool's, hold each rank's one kv head of the
    two."""
    want, jstats = _jax(jax_runs, case, "tiny")
    for r in ranks.values():
        res = r[run]
        assert res["tokens"] == want
        assert res["drained"]
    # the two ranks' pools hold one kv head each of the two
    assert ranks[0][run]["pool"][-2:] == (1, R.TP_CFG.head_dim)
    if run == "rect":
        assert ranks[0][run]["pool"][1:3] == (2, 48)
        # k and v of each layer: 2 slots x 48 rows x 1 kv head, f32
        assert ranks[0][run]["kv_bytes"] == R.TP_CFG.n_layers * 2 * 2 * 48 \
            * R.TP_CFG.head_dim * 4
    st = ranks[0]["prefix"]["stats"]
    if run == "prefix":
        for k in ("prefix_hit_tokens", "cow_copies", "shared_pages"):
            assert st[k] == jstats[k] > 0, k


def test_tp_engine_collectives_per_forward(ranks):
    """Per forward (an admission's prefill or a decode step): one
    all-reduce per row-parallel linear (2 per layer) plus the embedding's,
    and one all-gather of the logits."""
    res = ranks[0]["plain"]
    st, c = res["stats"], res["comm"]
    forwards = st["admissions"] + st["decode_steps"]
    assert c["all_reduce"] == (2 * R.TP_CFG.n_layers + 1) * forwards
    assert c["all_gather"] == forwards
    assert c["check"] == st["steps"]               # debug: lockstep per tick


def test_tp_spec_engine_matches_jax_counters(case, ranks, jax_runs):
    want, jstats = _jax(jax_runs, case, "tiny", spec_rank_frac=0.5,
                        spec_k=2)
    for r in ranks.values():
        assert r["spec"]["tokens"] == want
        st = r["spec"]["stats"]
        for k in ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
                  "spec_rollback_tokens"):
            assert st[k] == jstats[k], k
    assert jstats["spec_rollback_tokens"] > 0


def test_tp_kv_heads_replicated_qwen_smoke(case, ranks, jax_runs):
    """qwen1.5-110b's smoke config has 1 kv head: each rank keeps wk / wv
    and the pool whole and its 4 query heads read that head; MLP through
    the two-call route (MAX_FUSED_RANK 64 in the ranks)."""
    want, _ = _jax(jax_runs, case, "qwen")
    cfg = case["qwen_cfg"]
    for r in ranks.values():
        for run in ("qwen", "qwen_rect"):
            assert r[run]["tokens"] == want
            assert r[run]["pool"][-2:] == (1, cfg.head_dim)
    # the rectangle stays whole on every rank: (layers, slots, rows, 1, D)
    assert ranks[0]["qwen_rect"]["pool"][:3] == (cfg.n_layers, 2, 48)


def test_launch_serve_rect_tp_ranks(ranks):
    """``launch.serve --rect --tp 2 --tp-backend gloo``'s serving loop
    (``_serve`` over each rank's shards, with the CLI's ServeConfig from
    its parsed arguments) emits on both ranks the tokens that the same
    loop emits on the unsharded model: every request, ``--max-new``
    tokens each."""
    want = ranks[0]["cli_rect_unsharded"]
    assert sorted(want) == [0, 1, 2]
    assert all(len(t) == 4 for t in want.values())
    for r in ranks.values():
        assert r["cli_rect"] == r["cli_rect_unsharded"] == want


def test_tp_lockstep_check_and_broadcast(ranks):
    """A rank that queued what the other did not fails the lockstep check
    on both ranks; a host object broadcast from rank 0 reaches both."""
    assert all("ranks left lockstep" in r["lockstep"]
               for r in ranks.values())
    assert [r["broadcast"] for r in ranks.values()] == [{"from": 0}] * 2
    assert [r["coords"] for r in ranks.values()] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1}]


def test_launch_serve_tp_cli(monkeypatch, tmp_path, capfd):
    """``launch.serve --tp 2 --tp-backend gloo`` (the FP demo teacher, in
    bf16 and sampled, so its tokens are not held to the unsharded run's;
    the engine tests above hold f32 greedy tokens) serves every request
    under wave admission, and only rank 0 prints: one line with the
    backend, the ranks' devices and the mesh, one summary."""
    from repro_torch.launch import serve
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    got = serve.main(["--device", "cpu", "--fp", "--requests", "3",
                      "--max-new", "4", "--engine", "wave", "--tp", "2",
                      "--tp-backend", "gloo"])
    assert sorted(got) == [0, 1, 2] and all(len(t) == 4
                                            for t in got.values())
    out = capfd.readouterr().out
    assert out.count("[serve] tensor-parallel: 2 ranks over gloo on "
                     "['cpu', 'cpu'], mesh {'data': 1, 'model': 2}") == 1
    assert out.count("[serve] engine=wave on cpu: 3 requests") == 1


# ---------------------------------------------------------------------------
# (d) refusals
# ---------------------------------------------------------------------------


def _tiny_params():
    return R.params_from_numpy(packed_model(R.TP_CFG, 0, min_dim=32), "cpu")


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_tp_refuses_other_families(arch):
    """The SSM, hybrid and VLM families are served over two ranks and
    refused only where their heads do not divide the ranks: over three,
    mamba2's 8 SSD heads (its ``n_heads`` is 0, which divides anything),
    a zamba2 variant's 8 SSD heads beside 6 attention heads that divide,
    the VLM's 4 query heads."""
    cfg = f32(get_smoke(arch))
    from repro_torch.serve.engine import TP_FAMILIES, check_tp_serving
    assert cfg.family in TP_FAMILIES
    check_tp_serving(cfg, _mesh())
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=6)
    match = "query heads" if cfg.family == "vlm" else "8 SSD heads"
    with pytest.raises(NotImplementedError, match=match):
        check_tp_serving(cfg, _mesh(None, (1, 3)))
    with pytest.raises(NotImplementedError, match=match):
        InferenceEngine({"embed": torch.zeros(1)}, cfg, device="cpu",
                        mesh=_mesh(None, (1, 3)))


def test_tp_refuses_clock_and_plan_features():
    p = _tiny_params()
    with pytest.raises(NotImplementedError, match="item 12d"):
        InferenceEngine(p, R.TP_CFG, device="cpu", mesh=_mesh(),
                        faults=FaultPlan([]))
    eng = InferenceEngine(p, R.TP_CFG, ServeConfig(page_size=8),
                          max_len=32, device="cpu", mesh=_mesh())
    with pytest.raises(NotImplementedError, match="item 12d"):
        eng.submit(Request(0, np.arange(4), deadline_s=1.0))
    with pytest.raises(NotImplementedError, match="item 12d"):
        eng.drain(timeout=1.0)
    from repro_torch.serve import recovery
    with pytest.raises(NotImplementedError, match="item 12d"):
        recovery.snapshot(eng)
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--tp", "2", "--tp-backend", "gloo",
                    "--deadline", "1"])


def test_tp_refuses_heads_that_do_not_divide():
    p = _tiny_params()
    with pytest.raises(NotImplementedError, match="query heads"):
        InferenceEngine(p, R.TP_CFG, device="cpu",
                        mesh=_mesh(None, (1, 3)))
    # 8 heads over 4 ranks divide, but wo's d_in of 64 packs into 2 words,
    # which do not: the reference leaves wo whole and lets GSPMD regather
    # its input; explicit TP refuses the model
    wide = dataclasses.replace(R.TP_CFG, n_heads=8, n_kv_heads=8,
                               head_dim=8)
    with pytest.raises(NotImplementedError, match="split on its d_in"):
        InferenceEngine(R.params_from_numpy(packed_model(wide, 0, min_dim=32),
                                            "cpu"), wide, device="cpu",
                        mesh=_mesh(None, (1, 4)))


def test_nccl_needs_a_card_per_rank(capsys):
    with pytest.raises(RuntimeError, match="nccl puts each"):
        tmesh.run_ranks(R.rank_checks, 2, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.check_backend("mpi", 2)
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--tp", "2"])
    assert "nccl puts each" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the api names this slice adds, against JAX's
# ---------------------------------------------------------------------------


def test_api_mesh_names_and_batch_server(case, jax_runs):
    assert tapi.ShardingPolicy().__dict__ == japi.ShardingPolicy().__dict__
    want, _ = _jax(jax_runs, case, "tiny")
    with pytest.warns(DeprecationWarning):
        srv = tapi.BatchServer(R.params_from_numpy(case["tiny"], "cpu"),
                               R.TP_CFG, ServeConfig(greedy=True,
                                                     page_size=8),
                               max_batch=2, max_len=48, device="cpu")
    for uid, (p, b) in enumerate(zip(case["prompts"], case["budgets"])):
        srv.submit(Request(uid, p, max_new_tokens=b))
    got = {u: r.output.tolist() for u, r in srv.run().items()}
    assert got == want


def test_set_kernel_policy_is_process_wide():
    prev = tapi.set_kernel_policy("ref")
    try:
        assert ops.current_kernel_policy().mode == "ref"
        with ops.kernel_policy(ops.KernelPolicy(mode="cuda")):
            assert ops.current_kernel_policy().mode == "cuda"
        assert tapi.set_kernel_policy(prev).mode == "ref"
    finally:
        tapi.set_kernel_policy(prev)
    assert ops.current_kernel_policy() is prev


@pytest.mark.parametrize("arch", ARCHS)
def test_quantizable_paths_match_jax(arch):
    cfg = get_config(arch)
    for md in (16, 48):
        want = [p for p, _ in jsurgery.quantizable_paths(
            jparam_specs(cfg), cfg, md)]
        got = [p for p, _ in tapi.quantizable_paths(
            tsurgery.param_specs(cfg), cfg, md)]
        assert got == want and want
