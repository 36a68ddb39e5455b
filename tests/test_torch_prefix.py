"""The port's prefix cache against the JAX reference.

Covered: the refcounted allocator and the prefix index driven in
lockstep with JAX's through one sequence of operations (admit with shared
pages, register, match and probe, protect, release, trim, copy on write,
reservation under pressure, reclaim), compared after every step; the
suffix prefill (``transformer.prefill(start_pos=, block_tables=)``)
against JAX's on the same pool; the engine with the cache on against
JAX's engine (a shared system prompt, a full-cover duplicate, page
boundary off-by-ones, an overcommitted pool that evicts and preempts):
tokens, the prefix / copy-on-write / eviction / preemption counters and
the drained pool; which kernels a hit's admission reaches; and the
reference's own prefix tests of speculative rollback over shared pages,
uid reuse after eviction and ``clear``.

The smoke model is packed from a seed and served in f32 with greedy
decoding, page size 8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_common import (assert_close, f32, jax_tree, packed_model, tol,
                           torch_params)
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import paging as jpaging
from repro.serve import prefix as jprefix
from repro_torch.kernels import megakernel, ops
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging, prefix
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request

PS = 8
MODES = {"ref": ops.KernelPolicy(mode="ref"),
         "kernels": ops.KernelPolicy(mode="cuda")}
COUNTERS = ("prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
            "evicted_pages", "shared_pages", "preemptions")


@pytest.fixture(scope="module")
def model():
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    tree = packed_model(cfg, seed=0)
    return cfg, jax_tree(tree), torch_params(tree)


def _toks(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# the allocator and the index, in lockstep with JAX's
# ---------------------------------------------------------------------------


class _Pair:
    """JAX's PagedKVState + PrefixCache and the port's, driven together.
    Both index keys are ``hash((parent, int32 bytes))`` in this one
    process, so the keys themselves compare equal."""

    def __init__(self, cfg, max_batch, max_len, n_pages):
        self.j = jpaging.PagedKVState(cfg, max_batch, max_len, PS, n_pages,
                                      kinds={"linear"})
        self.t = paging.PagedKVState(max_batch, max_len, PS, n_pages)
        self.jp = jprefix.PrefixCache(self.j)
        self.tp = prefix.PrefixCache(self.t)

    def both(self, name, *args, index=False, **kw):
        """Call `name` on both allocators (or both indexes) with the same
        arguments and return JAX's result after checking they agree."""
        a, b = (self.jp, self.tp) if index else (self.j, self.t)
        want = getattr(a, name)(*args, **kw)
        got = getattr(b, name)(*args, **kw)
        if isinstance(want, dict):
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(want[k], got[k])
        else:
            assert want == got, (name, want, got)
        return want

    def same(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(j.ref, t.ref)
        np.testing.assert_array_equal(j.cached, t.cached)
        assert j._free == t._free
        np.testing.assert_array_equal(j.tables["linear"], t.tables["linear"])
        assert j._mapped == t._mapped
        assert [sorted(p) for p in j._slot_pages] == \
            [sorted(p) for p in t._slot_pages]
        assert sorted(self.jp.entries) == sorted(self.tp.entries)
        for k, e in self.jp.entries.items():
            f = self.tp.entries[k]
            assert (e.parent, e.tokens, e.page, e.children, e.tick) == \
                (f.parent, f.tokens, f.page, f.children, f.tick)
        for name in ("available_pages", "used_pages", "shared_page_count",
                     "cached_page_count", "peak_used_pages"):
            assert getattr(j, name) == getattr(t, name), name
        j.check_invariants()
        t.check_invariants()
        self.jp.check_invariants()
        self.tp.check_invariants()


# prompts of whole and partial chunks over two distinct chunks (bit i of
# `code` picks chunk i), so that matches, full covers and divergent chains
# all occur
_CHUNKS = np.arange(2 * PS, dtype=np.int32).reshape(2, PS) * 7 % 251


def _prompt(code: int, n: int) -> np.ndarray:
    chunks = [_CHUNKS[(code >> i) & 1] for i in range(-(-n // PS))]
    return np.concatenate(chunks)[:n]


_OPS = st.lists(st.tuples(
    st.sampled_from(["admit"] * 3 + ["release"] * 2 + [
        "trim", "reserve", "cow", "reclaim", "probe"]),
    st.integers(0, 2), st.integers(0, 31),
    st.one_of(st.integers(1, 40), st.sampled_from([PS, 2 * PS, 3 * PS]))),
    min_size=4, max_size=30)


@settings(deadline=None, max_examples=100, derandomize=True)
@given(ops_=_OPS)
def test_allocator_and_index_lockstep_with_jax(model, ops_):
    cfg = model[0]
    pair = _Pair(cfg, max_batch=3, max_len=40, n_pages=8)
    pos = [0, 0, 0]                           # rows written per slot
    for op, slot, code, n in ops_:
        busy = bool(pair.j._slot_pages[slot])
        if op == "admit":
            if busy:                          # the occupant finishes first
                pair.both("release", slot)
            prompt = _prompt(code, n)
            p, pages, keys = pair.both("match", prompt, index=True)
            pair.both("protect", keys, index=True)
            need = pair.t.pages_for_prompt(n) + (1 if p == n else 0) \
                - len(pages)
            if pair.t.available_pages >= need:
                pair.both("admit", slot, n, shared=pages)
                start = n - 1 if p == n else p
                while True:                   # the engine's _cow_rows
                    idx = pair.both("next_shared_write_page", slot, start, n)
                    if idx is None:
                        break
                    assert pair.both("cow", slot, idx) is not None
                pair.both("register", prompt, n,
                          pair.j.tables["linear"][slot], index=True)
                pos[slot] = n
            pair.both("unprotect_all", index=True)
        elif op == "release" and busy:
            pair.both("release", slot)
        elif op == "trim" and busy:
            pos[slot] = min(pos[slot], n)
            pair.both("trim", slot, pos[slot])
        elif op == "reserve" and busy:
            rows = min(pos[slot] + n, 40)
            if pair.both("reserve_rows", slot, rows):
                pos[slot] = rows
        elif op == "cow" and busy:
            idx = pair.both("next_shared_write_page", slot, 0, pos[slot])
            if idx is not None:
                pair.both("cow", slot, idx)
        elif op == "reclaim":
            pair.both("reclaim", n % 4, index=True)
        elif op == "probe":
            pair.both("match", _prompt(code, n), probe=True, index=True)
            pair.both("evictable_count", index=True)
        pair.same()
    for s in range(3):
        pair.both("release", s)
    assert not pair.t.ref.any()
    assert pair.t.used_pages == pair.t.cached_page_count
    assert pair.both("clear", index=True) >= 0 and pair.t.used_pages == 0
    pair.same()


def test_copy_page_copies_every_layer():
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    cache = paging.init_paged_cache(cfg, 5, PS, device="cpu")
    for name in ("k", "v"):
        cache["layers"][name].normal_(generator=torch.Generator()
                                      .manual_seed(1))
    before = {k: v.clone() for k, v in cache["layers"].items()}
    assert paging.copy_page(cache, 3, 1) is cache
    for name, pool in cache["layers"].items():
        assert torch.equal(pool[:, 1], before[name][:, 3])
        keep = [0, 2, 3, 4]
        assert torch.equal(pool[:, keep], before[name][:, keep])


# ---------------------------------------------------------------------------
# the suffix prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("start,S", [(16, 7), (16, 1), (8, 9)])
def test_suffix_prefill_matches_jax(model, mode, start, S):
    """rows [0, start) of the slot hold a prefix's KV (random here), the
    suffix's S tokens are prefilled into the pool through the slot's
    table: the logits and the whole pool after the call agree with JAX's
    within the f32 tolerance."""
    cfg, jparams, tparams = model
    rng = np.random.default_rng(start * 31 + S)
    n_pages, L = 9, cfg.n_layers
    shape = (L, n_pages, PS, cfg.n_kv_heads, cfg.head_dim)
    pools = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    table = np.array([[6, 2, 7, 4, 0]], np.int32)      # 5 entries, 4 mapped
    toks = _toks(cfg, S, seed=start + S)
    jcache = {"layers": {k: jnp.asarray(v) for k, v in pools.items()}}
    jl, jcache = JT.prefill(jparams, cfg, jnp.asarray(toks[None]), jcache,
                            start_pos=jnp.asarray([start], jnp.int32),
                            block_tables={"linear": jnp.asarray(table)})
    tp = tparams
    if mode == "kernels":
        tp = tsurgery.merge_projection_groups(tparams)
    tcache = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in pools.items()}}
    with ops.kernel_policy(MODES[mode]):
        tl, tcache = TT.prefill(
            tp, cfg, torch.from_numpy(toks[None].astype(np.int64)), tcache,
            start_pos=torch.tensor([start]),
            block_tables={"linear": torch.from_numpy(table)})
    assert tl.shape == (1, 1, cfg.vocab_size)
    assert_close(jl, tl, tol("f32"), "suffix prefill logits")
    for k in ("k", "v"):
        assert_close(jcache["layers"][k], tcache["layers"][k], tol("f32"),
                     f"suffix prefill pool {k}")
    with pytest.raises(ValueError, match="block_tables"):
        TT.prefill(tp, cfg, torch.zeros((1, 2), dtype=torch.long), tcache,
                   start_pos=torch.tensor([start]))
    with pytest.raises(ValueError, match="block_tables"):
        TT.decode_step(tp, cfg, torch.zeros((1, 1), dtype=torch.long),
                       tcache, torch.tensor([start]))


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------


def _traces(cfg):
    """(prompts, budgets, serve kw, engine kw) of the two engine traces."""
    sys_p = _toks(cfg, 2 * PS, seed=10)
    base = _toks(cfg, 2 * PS + 1, seed=12)
    shared = [np.concatenate([sys_p, _toks(cfg, n, seed=20 + n)])
              for n in (3, 7, 5)]
    shared += [sys_p.copy(), shared[0].copy(), np.concatenate(
        [sys_p, _toks(cfg, PS, seed=29)])]
    shared.append(shared[-1].copy())          # full cover of 3 pages
    shared += [base[:PS - 1], base[:PS], base[:PS + 1], base[:2 * PS], base]
    budgets = [6, 8, 5, 7, 6, 4, 5, 5, 5, 5, 5, 5]
    pressure = [np.concatenate([sys_p, _toks(cfg, 4, seed=30 + i)])
                for i in range(4)]
    pressure += [np.concatenate([_toks(cfg, 2 * PS, seed=14),
                                 _toks(cfg, 4, seed=40 + i)])
                 for i in range(3)]
    return {"shared": (shared, budgets, {}, dict(max_batch=3, max_len=48)),
            "pressure": (pressure, [8] * 7, dict(kv_pool_pages=8),
                         dict(max_batch=3, max_len=32))}


def _serve(request, prompts, budgets, eng, uids=None):
    """Submit every prompt to `eng` (JAX's or the port's, with its
    `request` type) and drain it; returns ({uid: tokens}, eng)."""
    for uid, (p, b) in zip(uids or range(len(prompts)),
                           zip(prompts, budgets)):
        eng.submit(request(uid, p, max_new_tokens=b))
    return {u: r.output for u, r in eng.run().items()}, eng


@pytest.fixture(scope="module")
def jax_runs(model):
    cfg, jparams, _ = model
    out = {}
    for name, (prompts, budgets, kw, ekw) in _traces(cfg).items():
        eng = JEngine(jparams, cfg, JServeConfig(greedy=True, page_size=PS,
                                                 **kw), **ekw)
        got, eng = _serve(JRequest, prompts, budgets, eng)
        out[name] = (got, dict(eng.stats), dict(eng.admission_step))
    return out


def _port_engine(tparams, cfg, policy, ekw, **kw):
    return InferenceEngine(tparams, cfg, ServeConfig(
        greedy=True, page_size=PS, debug=True, **kw), device="cpu",
        policy=policy, **ekw)


def _drained(eng):
    assert not eng.kv.ref.any(), "a drained engine maps no page"
    assert eng.kv.used_pages == eng.kv.cached_page_count
    assert not eng.kv.tables["linear"].any()
    eng.check_invariants()


@pytest.mark.parametrize("trace", ["shared", "pressure"])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(model, jax_runs, trace, mode):
    cfg, _, tparams = model
    prompts, budgets, kw, ekw = _traces(cfg)[trace]
    want, jstats, jsteps = jax_runs[trace]
    got, eng = _serve(Request, prompts, budgets,
                      _port_engine(tparams, cfg, MODES[mode], ekw, **kw))
    plain, _ = _serve(Request, prompts, budgets, _port_engine(
        tparams, cfg, MODES[mode], ekw, prefix_cache=False, **kw))
    assert sorted(got) == sorted(want) == sorted(plain)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
        np.testing.assert_array_equal(plain[u], got[u])
    assert {k: eng.stats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}
    assert eng.admission_step == jsteps
    assert eng.stats["prefix_hit_tokens"] > 0
    if trace == "shared":
        assert eng.stats["cow_copies"] >= 2 and eng.stats["shared_pages"] > 0
    else:
        assert eng.stats["evicted_pages"] > 0 and eng.stats["preemptions"] > 0
    _drained(eng)
    assert eng.prefix.clear() > 0 and eng.kv.used_pages == 0


def test_hit_admission_reaches_the_kernels(model, monkeypatch):
    """On the kernel path a hit's suffix prefill reads the pool through
    ``ops.paged_attention`` with S > 1 queries, and a full-cover hit's
    one-token re-prefill takes the decode megakernel."""
    cfg, _, tparams = model
    seen = []                      # (S of the prefill, kernel, its S)
    real_prefill, real_pa = TT.prefill, ops.paged_attention
    real_mega = megakernel.decode_step_megakernel_raw
    state = {"S": None}

    def prefill(params, cfg_, tokens, *a, start_pos=None, **k):
        state["S"] = None if start_pos is None else tokens.shape[1]
        try:
            return real_prefill(params, cfg_, tokens, *a,
                                start_pos=start_pos, **k)
        finally:
            state["S"] = None

    def pa(q, *a, **k):
        if state["S"] is not None:
            seen.append((state["S"], "paged_attention", q.shape[1]))
        return real_pa(q, *a, **k)

    def mega(x, *a, **k):
        if state["S"] is not None:
            seen.append((state["S"], "megakernel", 1))
        return real_mega(x, *a, **k)
    monkeypatch.setattr(TT, "prefill", prefill)
    monkeypatch.setattr(ops, "paged_attention", pa)
    monkeypatch.setattr(megakernel, "decode_step_megakernel_raw", mega)
    sys_p = _toks(cfg, 2 * PS, seed=50)
    eng = _port_engine(tparams, cfg, MODES["kernels"],
                       dict(max_batch=2, max_len=40))
    _serve(Request, [sys_p, np.concatenate(
        [sys_p, _toks(cfg, 5, seed=51)]), sys_p.copy()], [3, 3, 3], eng)
    assert (5, "paged_attention", 5) in seen
    assert (1, "megakernel", 1) in seen
    assert all(kind != "megakernel" or s == 1 for s, kind, _ in seen)
    assert eng.stats["cow_copies"] >= 1


# ---------------------------------------------------------------------------
# the reference's prefix tests, on the port
# ---------------------------------------------------------------------------


def test_spec_rollback_on_shared_pages_is_safe():
    """Speculative drafts write past the committed frontier into pages a
    hit may share; the reserve copies them on write first and rollback
    only unrefs, so cached pages survive rejected drafts and a second
    trace through the warmed index emits the tokens of the engine without
    sharing. Packed at 6 bits per weight so that the draft's rank is cut
    and it disagrees with the verifier."""
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    tparams = torch_params(packed_model(cfg, seed=16, bpw=6.0))
    sys_p = _toks(cfg, 2 * PS, seed=17)
    prompts = [sys_p.copy(), np.concatenate([sys_p, _toks(cfg, 5, seed=18)]),
               np.concatenate([sys_p, _toks(cfg, 9, seed=19)])]
    budgets = [8, 10, 8]
    ekw = dict(max_batch=3, max_len=48)
    pol = MODES["kernels"]
    plain, _ = _serve(Request, prompts, budgets, _port_engine(
        tparams, cfg, pol, ekw, prefix_cache=False))
    eng = _port_engine(tparams, cfg, pol, ekw, spec_rank_frac=0.5, spec_k=4)
    out1, eng = _serve(Request, prompts, budgets, eng)
    out2, _ = _serve(Request, prompts, budgets, eng, uids=[10, 11, 12])
    for u in plain:
        np.testing.assert_array_equal(plain[u], out1[u])
        np.testing.assert_array_equal(plain[u], out2[10 + u])
    assert eng.stats["spec_rollback_tokens"] > 0, \
        "draft never rejected: rollback untested"
    assert eng.stats["prefix_hit_tokens"] > 0
    _drained(eng)


def test_uid_reuse_after_eviction_cannot_alias(model):
    """A small pool forces index evictions; the same engine then serves
    reused uids with other prompts. The index keys on token content, so
    neither the uids nor the recycled pages resolve stale entries."""
    cfg, _, tparams = model
    first = [np.concatenate([_toks(cfg, 16, seed=13),
                             _toks(cfg, 4, seed=30 + i)]) for i in range(4)]
    second = [np.concatenate([_toks(cfg, 16, seed=14),
                              _toks(cfg, 4, seed=40 + i)]) for i in range(4)]
    ekw = dict(max_batch=3, max_len=32)
    pol = MODES["ref"]
    plain, _ = _serve(Request, first + second, [6] * 8, _port_engine(
        tparams, cfg, pol, ekw, kv_pool_pages=10, prefix_cache=False))
    eng = _port_engine(tparams, cfg, pol, ekw, kv_pool_pages=10)
    out1, eng = _serve(Request, first, [6] * 4, eng)
    out2, _ = _serve(Request, second, [6] * 4, eng, uids=range(4))
    for u in range(4):
        np.testing.assert_array_equal(plain[u], out1[u])
        np.testing.assert_array_equal(plain[4 + u], out2[u])
    assert eng.stats["evicted_pages"] > 0, \
        "the pool never pressed the index: the test lost its premise"
    _drained(eng)


def test_prefix_clear_requires_drained_and_empties(model):
    cfg, _, tparams = model
    eng = _port_engine(tparams, cfg, MODES["ref"],
                       dict(max_batch=3, max_len=48))
    eng.submit(Request(0, _toks(cfg, 16, seed=15), max_new_tokens=4))
    assert eng.step() == [] and eng.active.any()
    with pytest.raises(paging.PageAccountingError, match="live sharers"):
        eng.prefix.clear()                     # the slot still maps them
    eng.run()
    assert eng.kv.cached_page_count == 2
    assert eng.prefix.clear() == 2
    assert len(eng.prefix) == 0 and eng.kv.used_pages == 0
