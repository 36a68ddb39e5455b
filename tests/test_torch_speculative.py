"""Self-speculative decoding in the port against the JAX reference.

The same seeded packed smoke model (f32) goes to both packages. It is
packed at 6 bits per weight so that its ranks (wq/wo 160, wk/wv 96, MLP
224) leave room to truncate: at 1 bit every smoke rank is the 32-column
minimum and a draft would be the full model. At frac 0.5 the merged QKV
group truncates its common rank 160 to 64, so wk/wv keep 64 of their 96
columns, while the unmerged layout truncates wk/wv to 32: the two
dispatch structures draft different tokens, and only the verified
tokens are compared across them.

Covered: ``truncated_rank`` and the zero-copy ``rank_truncated_view``;
``eff_rank`` through the layers (against JAX's layers on JAX's view, and
against the full model with the trailing components zeroed); the paging
rollback primitives; the multi-token paged read over a dirty pool; and
the engine: greedy tokens equal the plain engine's and JAX's speculative
engine's, the spec counters equal JAX's in the unmerged layout, rollback
leaks no page, one host read per cycle, the gating errors and dynamic k.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, f32, jax_tree, packed_model, tol,
                           torch_params)
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.api import NanoQuantModel
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging, speculative
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request

BPW = 6.0
LOGITS_TOL = 1e-4          # whole-model logits (tests/test_torch_model.py)
# the port's dispatch structures and JAX's policy for the same layout:
# "ref" unmerged plain oracles; "kernels" merged groups and the megakernel
# (the wrappers' plain versions on the CPU; Pallas interpret in JAX)
MODES = {"ref": (ops.KernelPolicy(mode="ref"), jops.KernelPolicy(mode="ref")),
         "kernels": (ops.KernelPolicy(mode="cuda"),
                     jops.KernelPolicy(mode="pallas", interpret=True))}
LENS, BUDGETS = [3, 9, 17, 5, 12], [6, 3, 5, 8, 4]


@pytest.fixture(scope="module")
def model():
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    tree = packed_model(cfg, seed=0, bpw=BPW)
    return cfg, tree, jax_tree(tree), torch_params(tree)


def _layouts(mode, jparams, tparams):
    """Both packages' trees in `mode`'s layout (merged groups added on the
    kernel path, as each engine does)."""
    if mode == "kernels":
        return (jsurgery.merge_projection_groups(jparams),
                tsurgery.merge_projection_groups(tparams))
    return jparams, tparams


def _jview0(jtree, frac):
    """Layer 0 of JAX's view of a stacked JAX tree."""
    return jax.tree.map(lambda a: a[0],
                        jsurgery.rank_truncated_view(jtree, frac)["layers"])


def _tview0(ttree, frac):
    """Layer 0 of the port's view of its per-layer list, as the engine
    takes it."""
    return tsurgery.rank_truncated_view(TT.split_layers(ttree),
                                        frac)["layers"][0]


# ---------------------------------------------------------------------------
# the rank view
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frac", [0.01, 0.3, 0.5, 0.75, 1.0])
def test_truncated_rank_matches_jax(frac):
    for r in (32, 64, 96, 160, 384, 992, 1600, 4064, 6976):
        for align in (32, 64):
            assert tsurgery.truncated_rank(r, frac, align) == \
                jsurgery.truncated_rank(r, frac, align), (r, frac, align)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _at(node, path):
    for k in path:
        node = node[k]
    return node


@pytest.mark.parametrize("merged", [False, True])
def test_view_is_zero_copy(model, merged):
    """The engine's tree (per-layer list, merged groups on the kernel
    path): every tensor of the view is the engine's tensor, dicts with no
    truncated rank are the same objects, and frac 1.0 returns the tree."""
    _, _, _, tparams = model
    tree = tparams
    if merged:
        tree = tsurgery.merge_projection_groups(tree)
    tree = TT.split_layers(tree)
    view = tsurgery.rank_truncated_view(tree, 0.5)
    assert isinstance(view["layers"], list) and view["layers"] is not \
        tree["layers"]
    n = 0
    for path, leaf in _leaves(view):
        if isinstance(leaf, torch.Tensor):
            src = _at(tree, path)
            assert leaf is src and leaf.data_ptr() == src.data_ptr(), path
            n += 1
        else:
            assert path[-1] == "eff_rank" and isinstance(leaf, int), path
    assert n == sum(isinstance(x, torch.Tensor) for _, x in _leaves(tree))
    assert view["embed"] is tree["embed"]
    lv, lt = view["layers"][0], tree["layers"][0]
    assert lv["ln1"] is lt["ln1"]
    assert lv["attn"]["wq"]["eff_rank"] == 64
    assert lv["attn"]["wk"]["eff_rank"] == 32
    if merged:
        assert lv["attn"]["wqkv"]["eff_rank"] == 64
        assert lv["ffn"]["wgu"]["eff_rank"] == 96
    # a packed dict whose rank does not shrink is the same object
    small = {"a": {"qv": torch.zeros((2, 32), dtype=torch.int32),
                   "qu_t": torch.zeros((1, 8), dtype=torch.int32)},
             "b": [torch.ones(1)]}
    assert tsurgery.rank_truncated_view(small, 0.5) is small
    assert tsurgery.rank_truncated_view(tree, 1.0) is tree
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="rank_frac"):
            tsurgery.rank_truncated_view(tree, bad)


# ---------------------------------------------------------------------------
# eff_rank through the layers
# ---------------------------------------------------------------------------


def _paged_inputs(cfg, seed, S=1):
    rng = np.random.default_rng(seed)
    PS, hkv, hd = 4, cfg.n_kv_heads, cfg.head_dim
    pool = rng.standard_normal((2, cfg.n_layers, 10, PS, hkv, hd)
                               ).astype(np.float32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 5, 2], np.int32)
    x = rng.standard_normal((3, S, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
    return pool, bt, pos, x, tok


@pytest.mark.parametrize("mode", list(MODES))
def test_eff_rank_layers_match_jax(model, mode):
    """dense, dense_merged and the attention block's decode (the
    megakernel branch on the kernel path) on the port's view equal JAX's
    layers on JAX's view of the same tree."""
    cfg, _, jparams, tparams = model
    tpol, jpol = MODES[mode]
    jtree, ttree = _layouts(mode, jparams, tparams)
    jl, tl = _jview0(jtree, 0.5), _tview0(ttree, 0.5)
    pool, bt, pos, x, _ = _paged_inputs(cfg, 1)
    xt = torch.from_numpy(x)
    with jops.kernel_policy(jpol), ops.kernel_policy(tpol):
        for blk, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wo"),
                          ("ffn", "w_down")):
            xin = x if name != "w_down" else np.tile(x, (1, 1, 2))
            want = JL.dense(jl[blk][name], jnp.asarray(xin))
            got = TL.dense(tl[blk][name], torch.from_numpy(xin))
            assert_close(want, got, tol("f32"), f"dense {name} ({mode})")
        if mode == "kernels":
            hd = cfg.head_dim
            for blk, key, dims in (
                    ("attn", "wqkv", (cfg.n_heads * hd, cfg.n_kv_heads * hd,
                                      cfg.n_kv_heads * hd)),
                    ("ffn", "wgu", (cfg.d_ff, cfg.d_ff))):
                want = JL.dense_merged(jl[blk][key], jnp.asarray(x),
                                       (None,) * len(dims), dims)
                got = TL.dense_merged(tl[blk][key], xt, dims)
                for i, (a, b) in enumerate(zip(want, got)):
                    assert_close(a, b, tol("f32"), f"{key}[{i}]")
        jc = {"k": jnp.asarray(pool[0, 0]), "v": jnp.asarray(pool[1, 0])}
        tc = {"k": torch.from_numpy(pool[0, 0].copy()),
              "v": torch.from_numpy(pool[1, 0].copy())}
        positions = pos[:, None]
        want, jc = JL.attention(jl["attn"], cfg, jnp.asarray(x),
                                jnp.asarray(positions), jc, jnp.asarray(pos),
                                jnp.asarray(bt))
        got, tc = TL.attention(tl["attn"], cfg, xt,
                               torch.from_numpy(positions).long(), tc,
                               torch.from_numpy(pos).long(),
                               torch.from_numpy(bt))
    assert_close(want, got, tol("f32"), f"attention ({mode})")
    for leaf in ("k", "v"):
        assert_close(jc[leaf][1:], tc[leaf][1:], tol("f32"),
                     f"attention pool {leaf} ({mode})")


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_draft_and_verify_decode_match_jax(model, mode, S):
    """A whole decode step over a paged pool: the draft view at S = 1 and
    the full-rank verify at S = 3 (rows pos..pos+2 written by the same
    call), against JAX's decode_step on the same layout."""
    cfg, _, jparams, tparams = model
    tpol, jpol = MODES[mode]
    jtree, ttree = _layouts(mode, jparams, tparams)
    if S == 1:
        jtree = jsurgery.rank_truncated_view(jtree, 0.5)
        ttree = tsurgery.rank_truncated_view(TT.split_layers(ttree), 0.5)
    pool, bt, pos, _, tok = _paged_inputs(cfg, 2, S)
    with jops.kernel_policy(jpol):
        want, jc = jax.jit(lambda p, t, c, q, b: JT.decode_step(
            p, cfg, t, c, q, block_tables={"linear": b}))(
                jtree, tok, {"layers": {"k": jnp.asarray(pool[0]),
                                        "v": jnp.asarray(pool[1])}},
                pos, bt)
    with ops.kernel_policy(tpol):
        got, tc = TT.decode_step(
            ttree, cfg, torch.from_numpy(tok).long(),
            {"layers": {"k": torch.from_numpy(pool[0].copy()),
                        "v": torch.from_numpy(pool[1].copy())}},
            torch.from_numpy(pos).long(),
            block_tables={"linear": torch.from_numpy(bt)})
    assert_close(want, got, LOGITS_TOL, f"decode S={S} ({mode})")
    for leaf in ("k", "v"):
        assert_close(jc["layers"][leaf][:, 1:], tc["layers"][leaf][:, 1:],
                     LOGITS_TOL, f"decode pool {leaf} S={S} ({mode})")


@pytest.mark.parametrize("mode", list(MODES))
def test_eff_rank_is_the_zeroed_full_model(model, mode):
    """The truncated linear is the full-rank linear with the trailing
    r − r' rank components zeroed (rmask), for a plain and a merged
    group; and the megakernel on a view is its oracle on the zeroed
    full-rank QKV group and the leading columns of wo."""
    cfg, _, _, tparams = model
    tpol = MODES[mode][0]
    lt = _tview0(tsurgery.merge_projection_groups(tparams), 1.0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, cfg.d_model)).astype(np.float32))
    rp = 64
    with ops.kernel_policy(tpol):
        p = lt["attn"]["wq"]
        got = TL.dense({**p, "eff_rank": rp}, x)
        cut = (torch.arange(p["qv"].shape[-1]) < rp).float()
        want = ref.lowrank_binary_matmul_fused_ref(
            x, p["qv"], p["qu_t"], p["s1"], p["s2"], rmask=cut)
        assert_close(want, got, tol("f32"), f"dense eff_rank ({mode})")
        mp = lt["attn"]["wqkv"]
        hd = cfg.head_dim
        dims = (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd)
        got = TL.dense_merged({**mp, "eff_rank": rp}, x, dims)
        cut = (torch.arange(mp["qv"].shape[-1]) < rp).float()
        for g, n in enumerate(dims):
            want = ref.lowrank_binary_matmul_fused_ref(
                x, mp["qv"][g], mp["qu_t"][g], mp["s1"][g], mp["s2"][g],
                rmask=mp["rmask"][g] * cut)[:, :n]
            assert_close(want, got[g], tol("f32"), f"merged[{g}] ({mode})")
    pool, bt, pos, _, _ = _paged_inputs(cfg, 3)
    wo = lt["attn"]["wo"]
    kw = dict(head_dim=hd, dims=dims[:2], theta=cfg.rope_theta,
              scale=hd ** -0.5)
    args = (torch.from_numpy(pool[0, 0]), torch.from_numpy(pool[1, 0]),
            torch.from_numpy(bt), torch.from_numpy(pos),
            torch.from_numpy(pos))
    got = ops.decode_step_megakernel(x, mp, wo, *args, eff_rank=rp,
                                     eff_rank_o=rp, policy=tpol, **kw)
    if mode == "ref":
        assert got is None              # the megakernel is a kernel path
        return
    zeroed = {**mp, "rmask": mp["rmask"] * cut}
    wo_cut = {**wo, "qv": wo["qv"][:, :rp].contiguous(),
              "qu_t": wo["qu_t"][:rp // 32].contiguous()}
    want = ref.decode_step_ref(x, zeroed, wo_cut, *args, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        assert_close(a, b, tol("f32"), f"megakernel {nm}")


# ---------------------------------------------------------------------------
# paging: the rollback primitives
# ---------------------------------------------------------------------------


def test_reserve_rows_and_trim():
    kv = paging.PagedKVState(max_batch=2, max_len=32, page_size=8, n_pages=7)
    kv.admit(0, 5)                                   # 1 page
    assert kv.used_pages == 1
    assert kv.reserve_rows(0, 17)                    # rows 0..16: 3 pages
    assert kv.used_pages == 3
    assert kv.reserve_rows(0, 17) and kv.used_pages == 3    # idempotent
    # trim back to 6 committed rows: keep ceil(6/8) = 1 page, free 2
    assert kv.trim(0, 6) == 2
    assert kv.used_pages == 1
    assert (kv.tables["linear"][0, 1:] == 0).all()
    assert kv.trim(0, 6) == 0                        # nothing to drop
    kv.check_invariants()
    kv.admit(1, 30)                                  # freed pages reused
    assert kv.used_pages == 5
    # a dry pool: the reservation fails, its partial mapping sticks, and
    # a retry after pages come back completes it
    assert not kv.reserve_rows(0, 32)
    kv.check_invariants()
    kv.release(1)
    assert kv.reserve_rows(0, 32) and kv.used_pages == 4
    kv.release(0)
    assert kv.used_pages == 0
    assert (kv.tables["linear"] == 0).all()
    kv.check_invariants()


def test_rollback_then_redraft_same_page():
    """A reject inside the committed page frees nothing and keeps the
    mapping; the next draft reserves into the same page. A draft that
    crossed into a fresh page gives it back and maps one again."""
    kv = paging.PagedKVState(max_batch=1, max_len=32, page_size=8, n_pages=5)
    kv.admit(0, 3)                             # 3 committed rows, page A
    assert kv.reserve_rows(0, 3 + 4)           # draft k=4: rows 3..6
    assert kv.used_pages == 1
    before = kv.tables["linear"][0].copy()
    assert kv.trim(0, 4) == 0                  # accept 1, reject 3
    assert (kv.tables["linear"][0] == before).all()
    assert kv.reserve_rows(0, 4 + 4)           # redraft: rows 4..7
    assert kv.used_pages == 1
    assert (kv.tables["linear"][0] == before).all()
    assert kv.reserve_rows(0, 8 + 4)           # rows 8..11: page B
    assert kv.used_pages == 2
    assert kv.trim(0, 8) == 1                  # reject all of page B
    assert kv.used_pages == 1
    assert kv.reserve_rows(0, 8 + 4) and kv.used_pages == 2
    kv.check_invariants()
    kv.release(0)
    assert kv.used_pages == 0


# ---------------------------------------------------------------------------
# the multi-token paged read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_multitoken_paged_read_over_dirty_pool(mode):
    """S = 3 queries (the kernel path's S-launch loop on the plain walk,
    and the ref path whole) over a pool whose rows past each slot's
    frontier hold random stale values: equal to JAX's oracle on the same
    dirty pool and on a pool with those rows zeroed."""
    rng = np.random.default_rng(43)
    B, S, Hq, Hkv, D, PS, pages = 3, 3, 4, 2, 16, 4, 3
    NP = B * pages + 1
    rows = pages * PS
    kp = rng.standard_normal((NP, PS, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    bt = np.arange(1, NP).reshape(B, pages).astype(np.int32)
    bt[2, 2] = 0                                 # a null-padded table
    p = np.array([3, PS - 1, 5], np.int32)       # slot 1 straddles a page
    kc, vc = kp.copy(), vp.copy()
    for b in range(B):
        for r in range(int(p[b]) + S, rows):
            kc[bt[b, r // PS], r % PS] = 0.0
            vc[bt[b, r // PS], r % PS] = 0.0
    tpol = MODES[mode][0]
    got = ops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(p), torch.from_numpy(p),
        scale=0.25, policy=tpol)
    for k_, v_ in ((kp, vp), (kc, vc)):
        want = jref.paged_attention_ref(
            jnp.asarray(q), jnp.asarray(k_), jnp.asarray(v_), jnp.asarray(bt),
            jnp.asarray(p), jnp.asarray(p), scale=0.25)
        assert_close(want, got, tol("f32"), f"paged S={S} ({mode})")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in lens]


def _serve_port(tparams, cfg, prompts, budgets, scfg, max_batch=2,
                max_len=40, policy=None, uids=None, eng=None):
    if eng is None:
        eng = InferenceEngine(tparams, cfg, scfg, max_batch=max_batch,
                              max_len=max_len, device="cpu", policy=policy)
    for uid, p, b in zip(uids or range(len(prompts)), prompts, budgets):
        eng.submit(Request(uid, p, max_new_tokens=b))
    return {u: r.output for u, r in eng.run().items()}, eng


_SPEC_KEYS = ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
              "spec_rollback_tokens", "spec_rollback_pages", "decode_steps",
              "tokens_emitted", "preemptions")


@pytest.fixture(scope="module")
def jax_runs(model):
    """JAX's plain and speculative engines on the mid-flight trace."""
    cfg, _, jparams, _ = model
    prompts = _prompts(cfg, LENS)
    base = dict(greedy=True, page_size=8, prefix_cache=False)
    out = {}
    for frac in (None, 0.5, 0.9, 1.0):
        eng = JEngine(jparams, cfg, JServeConfig(**base, spec_rank_frac=frac,
                                                 spec_k=4),
                      max_batch=2, max_len=40)
        for uid, (p, b) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(JRequest(uid, p, max_new_tokens=b))
            if uid == 1:                       # the rest admitted later
                eng.step()
        out[frac] = ({u: r.output for u, r in eng.run().items()},
                     {k: eng.stats[k] for k in _SPEC_KEYS})
    return prompts, out


@pytest.mark.parametrize("frac", [0.5, 0.9, 1.0])
@pytest.mark.parametrize("mode", list(MODES))
def test_spec_engine_matches_plain_and_jax(model, jax_runs, mode, frac):
    """Greedy tokens of the port's speculative engine equal its plain
    engine's and JAX's speculative engine's, with mid-flight admission:
    no draft accepted at frac 0.5 on this seeded model, some at 0.9 (a
    cycle commits 2 to 4 tokens), all at 1.0;
    in the unmerged layout (JAX's CPU engine's) the spec counters match
    too. The kernel path drafts through merged groups, which truncate
    otherwise, so there only tokens are compared."""
    cfg, _, _, tparams = model
    prompts, jax_out = jax_runs
    want, jstats = jax_out[frac]
    tpol = MODES[mode][0]
    outs = {}
    for f in (None, frac):
        scfg = ServeConfig(greedy=True, page_size=8, prefix_cache=False,
                           spec_rank_frac=f, spec_k=4, debug=True)
        eng = InferenceEngine(tparams, cfg, scfg, max_batch=2, max_len=40,
                              device="cpu", policy=tpol)
        for uid, (p, b) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(Request(uid, p, max_new_tokens=b))
            if uid == 1:
                eng.step()
        outs[f] = {u: r.output for u, r in eng.run().items()}
        assert eng.kv.used_pages == 0
    assert sorted(outs[frac]) == sorted(want) == sorted(jax_out[None][0])
    for u in want:
        np.testing.assert_array_equal(jax_out[None][0][u], want[u])
        np.testing.assert_array_equal(outs[None][u], outs[frac][u])
        np.testing.assert_array_equal(want[u], outs[frac][u])
    st = {k: eng.stats[k] for k in _SPEC_KEYS}
    assert st["spec_draft_tokens"] == st["spec_accepted_tokens"] + \
        st["spec_rollback_tokens"]
    assert st["decode_steps"] >= st["spec_cycles"] > 0
    if frac == 1.0:
        assert eng.spec.draft_params is eng.params
        assert st["spec_rollback_tokens"] == 0
    elif frac == 0.9:
        assert 0 < st["spec_accepted_tokens"] < st["spec_draft_tokens"]
    if mode == "ref":
        assert st == jstats


def _spy_host_reads(monkeypatch, counter):
    """Count every device→host read a tensor can make."""
    for name in ("cpu", "item", "tolist", "__bool__", "__int__",
                 "__float__", "__index__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, **k):
            counter[0] += 1
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)


@pytest.mark.parametrize("mode", list(MODES))
def test_one_host_read_per_cycle(model, mode, monkeypatch):
    cfg, _, _, tparams = model
    scfg = ServeConfig(greedy=True, page_size=8, spec_rank_frac=0.5,
                       spec_k=4)
    eng = InferenceEngine(tparams, cfg, scfg, max_batch=2, max_len=40,
                          device="cpu", policy=MODES[mode][0])
    for uid, p in enumerate(_prompts(cfg, [7, 12], seed=4)):
        eng.submit(Request(uid, p, max_new_tokens=12))
    reads, per_tick = [0], []
    real_tick = eng.spec.tick

    def tick(finished):
        reads[0] = 0
        real_tick(finished)
        per_tick.append(reads[0])
    monkeypatch.setattr(eng.spec, "tick", tick)
    _spy_host_reads(monkeypatch, reads)
    eng.run()
    assert per_tick and eng.stats["spec_cycles"] > 0
    assert per_tick == [1] * len(per_tick)


def test_rollback_never_leaks_pages(model):
    """An overcommitted pool (reservation preempts mid-flight slots while
    rollback trims draft pages), two drains with reused uids: every page
    comes home, the table is zero and the outputs reproduce."""
    cfg, _, _, tparams = model
    prompts = _prompts(cfg, [8, 8, 8, 8], seed=9)
    scfg = ServeConfig(greedy=True, page_size=8, kv_pool_pages=8,
                       prefix_cache=False, spec_rank_frac=0.5, spec_k=4,
                       debug=True)
    eng = InferenceEngine(tparams, cfg, scfg, max_batch=3, max_len=32,
                          device="cpu", policy=MODES["kernels"][0])
    first, _ = _serve_port(None, cfg, prompts, [12] * 4, None, eng=eng)
    assert eng.kv.used_pages == 0 and not eng.kv.tables["linear"].any()
    free = eng.kv.free_pages
    assert eng.stats["preemptions"] > 0
    assert eng.stats["spec_rollback_tokens"] > 0
    assert eng.stats["spec_rollback_pages"] > 0
    second, _ = _serve_port(None, cfg, prompts, [12] * 4, None, eng=eng,
                            uids=[0, 1, 2, 3])
    for u in first:
        np.testing.assert_array_equal(first[u], second[u])
    assert eng.kv.used_pages == 0 and eng.kv.free_pages == free
    plain, _ = _serve_port(tparams, cfg, prompts, [12] * 4,
                           dataclasses.replace(scfg, spec_rank_frac=None),
                           max_batch=3, max_len=32,
                           policy=MODES["kernels"][0])
    for u in first:
        np.testing.assert_array_equal(plain[u], first[u])


def test_gating_errors(model):
    cfg, _, _, tparams = model

    def build(**kw):
        return InferenceEngine(tparams, cfg, ServeConfig(
            **{"greedy": True, "page_size": 8, **kw}), max_batch=2,
            max_len=32, device="cpu")

    with pytest.raises(ValueError, match="greedy"):
        build(greedy=False, spec_rank_frac=0.5)
    with pytest.raises(ValueError, match="paged"):
        build(paged=False, spec_rank_frac=0.5)
    for frac in (0.0, 1.5):
        with pytest.raises(ValueError, match="spec_rank_frac"):
            build(spec_rank_frac=frac)
    for k, k_min in ((2, 3), (0, 1), (2, 0)):
        with pytest.raises(ValueError, match="spec_k"):
            build(spec_rank_frac=0.5, spec_k=k, spec_k_min=k_min)
    eng = build(spec_rank_frac=0.5)
    eng.kv.tables["ring"] = eng.kv.tables["linear"]
    with pytest.raises(ValueError, match="linear page tables"):
        speculative.SpecDecodeController(eng)


def test_dynamic_k_walks_down(model):
    """A draft at the smallest rank (frac 0.1: every linear at 32
    columns) accepts little on this seeded model, so the EMA walks k
    down from its ceiling and keeps it in [k_min, k_max]; acceptance
    covers exactly the submitted uids. The entry point a user calls
    (``NanoQuantModel.engine``) builds it."""
    cfg, tree, _, _ = model
    m = NanoQuantModel.from_numpy(tree, cfg, device="cpu")
    eng = m.engine(ServeConfig(greedy=True, page_size=8), max_batch=2,
                   max_len=48, spec_rank_frac=0.1, spec_k=4)
    ks = []
    real_tick = eng.spec.tick

    def tick(finished):
        real_tick(finished)
        ks.append(eng.spec.k)
    eng.spec.tick = tick
    out, _ = _serve_port(None, cfg, _prompts(cfg, [6, 6], seed=2),
                         [24, 24], None, eng=eng)
    assert eng.spec.acceptance_rate() < 0.4
    assert min(ks) < eng.spec.k_max
    assert all(eng.spec.k_min <= k <= eng.spec.k_max for k in ks)
    assert set(eng.spec.acceptance) == {0, 1}
    for uid in (0, 1):
        a, d = eng.spec.acceptance[uid]
        assert eng.spec.acceptance_rate(uid) == a / d
    assert eng.spec.acceptance_rate(99) == 0.0
    plain = m.generate(_prompts(cfg, [6, 6], seed=2), max_new_tokens=24,
                       scfg=ServeConfig(greedy=True, page_size=8))
    for uid in (0, 1):
        np.testing.assert_array_equal(plain[uid], out[uid])
