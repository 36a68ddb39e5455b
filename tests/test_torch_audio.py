"""The port's audio family (musicgen: the dense block over frames of 4
codebook ids, one embedding table per codebook, a head over all of them)
against the JAX reference, on musicgen-medium's smoke config (2 layers, d
64, 4 heads over 4 kv heads of 16, d_ff 128, 4 codebooks of 128) packed
from seed 0 at 1.0 bpw with ``min_dim=16``, so that every linear packs
and the QKV and gate-up groups merge.

Covered: the full-size template leaf for leaf (f32 and bf16: the (4,
2048, 1536) embedding, the (1536, 8192) head, ranks 736 and 1184) and the
smoke template at ``min_dim`` 16 and 8; ``embed_tokens`` and
``logits_fn`` in f32 and bf16; the forward, the bucket-padded rectangular
prefill and the paged decode (an inactive slot) in f32 on the plain
oracles and on the kernel wrappers' CPU dispatch (and the unfused
decode); ``sample_token`` greedy on (B, 1, K, V) against JAX's, and its
sampled draws inside each codebook's top-k; the engine's frames against
JAX's engine on the ``ref``, ``kernels`` and ``unfused`` modes with the
prefix cache on and off, a request ending on EOS at codebook 0 among
them, and the drained pool; a shared prefix of frames (hits, copies on
write, a full cover) against JAX's prefix engine, with its counters;
drain, snapshot and restore with (4,) frames crossing the packages both
ways; the speculative refusal; ``generate`` against JAX's; artifacts both
ways; ``launch.serve --arch musicgen-medium`` and its ``--shared-prefix``
refusal.

Inputs come from ``np.random.default_rng``; tolerances are
``_torch_common.tol`` (relative max-abs f32 1e-5, bf16 3e-2); f32 engine
and ``generate`` frames are identical.
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

from _torch_common import (assert_close, cast_jax, f32, flat_templates,
                           jax_tree, leaves_equal, packed_model, pair, tol,
                           torch_params)
from repro import api as japi
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import recovery as jrecovery
from repro.serve.engine import generate as jgenerate
from repro.serve.engine import sample_token as jsample_token
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import recovery
from repro_torch.serve.engine import (InferenceEngine, ServeConfig, generate,
                                      sample_token)
from repro_torch.serve.scheduler import Request

ARCH = "musicgen-medium"
MIN_DIM = 16
K = 4                        # codebooks
MODES = {"ref": ops.KernelPolicy(mode="ref"),
         "kernels": ops.KernelPolicy(mode="cuda"),
         "unfused": ops.KernelPolicy(mode="cuda", megakernel=False)}
PS = 4                       # rows per page of the engine tests
COUNTERS = ("prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
            "evicted_pages", "shared_pages", "preemptions")


def _configs():
    cj, ct = f32(jconfigs.get_smoke(ARCH)), f32(tconfigs.get_smoke(ARCH))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.family == "audio" and ct.n_codebooks == K
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


def frames(cfg, shape, seed):
    """Codebook ids of `shape` (..., S, K) from a seed."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape + (K,)).astype(np.int32)


def prompts_of(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n, K)).astype(np.int32)
            for n in lens]


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_size_template_matches_jax(dtype):
    """musicgen-medium at full size, shapes only: the port's template
    equals JAX's leaf for leaf: the per-codebook embedding (4, 2048,
    1536), the head (1536, 4 x 2048), 48 dense blocks at 1.0 bpw with
    attention ranks 736 and FFN ranks 1184 (every rank within kernel #1's
    reach, so the two-call route, #4, never runs)."""
    cfg_t = dataclasses.replace(tconfigs.get_config(ARCH), dtype=dtype)
    cfg_j = dataclasses.replace(jconfigs.get_config(ARCH), dtype=dtype)
    want, got = flat_templates(jsurgery.abstract_quantized_params(cfg_j),
                               tsurgery.abstract_quantized_params(cfg_t))
    assert want == got
    t = tsurgery.abstract_quantized_params(cfg_t)
    assert t["embed"] == tsurgery.LeafSpec((4, 2048, 1536), dtype)
    assert t["lm_head"]["w"] == tsurgery.LeafSpec((1536, 8192), dtype)
    assert t["layers"]["attn"]["wq"]["qu_t"].shape == (48, 23, 1536)
    assert {k: v["qv"].shape[-1] for k, v in t["layers"]["attn"].items()} \
        == dict.fromkeys(("wq", "wk", "wv", "wo"), 736)
    assert {k: v["qv"].shape[-1] for k, v in t["layers"]["ffn"].items()} \
        == dict.fromkeys(("w_gate", "w_up", "w_down"), 1184)
    assert TT.stack_lead(cfg_t) == {"layers": (48,)}


@pytest.mark.parametrize("min_dim", [16, 8])
def test_smoke_template_matches_jax(min_dim):
    cj, ct = _configs()
    want, got = flat_templates(
        jsurgery.abstract_quantized_params(cj, 1.0, min_dim=min_dim),
        tsurgery.abstract_quantized_params(ct, 1.0, min_dim=min_dim))
    assert want == got
    t = tsurgery.abstract_quantized_params(ct, 1.0, min_dim=min_dim)
    assert "qv" in t["layers"]["attn"]["wk"] and "w" in t["lm_head"]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_embed_and_head_match_jax(model, dt):
    """``embed_tokens`` sums the 4 tables in codebook order, in the model
    dtype; ``logits_fn`` reshapes the head's (…, 4 x 128) to (…, 4,
    128)."""
    cj, ct, tree, _, _ = model
    dtype = "float32" if dt == "f32" else "bfloat16"
    cj, ct = (dataclasses.replace(c, dtype=dtype) for c in (cj, ct))
    jemb, temb = pair(tree["embed"], dt)
    jhead, thead = pair(tree["lm_head"]["w"], dt)
    toks = frames(ct, (2, 9), 1)
    want = JT.embed_tokens({"embed": jemb}, cj, jnp.asarray(toks))
    got = TT.embed_tokens({"embed": temb}, ct, torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, 9, ct.d_model)
    assert got.dtype == temb.dtype
    assert_close(want, got, tol(dt), f"embed {dt}")
    jh, th = pair(np.random.default_rng(2).standard_normal(
        (2, 3, ct.d_model)).astype(np.float32), dt)
    want = JT.logits_fn({"lm_head": {"w": jhead}}, cj, jh)
    got = TT.logits_fn({"lm_head": {"w": thead}}, ct, th)
    assert tuple(got.shape) == (2, 3, K, ct.vocab_size)
    assert_close(want, got, tol(dt), f"logits {dt}")


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_forward_matches_jax(model, jax_results, mode):
    cj, ct, _, jparams, tparams = model
    toks = frames(ct, (2, 11), 3)
    if "forward" not in jax_results:
        jax_results["forward"] = jax.jit(lambda p, t: JT.forward(
            p, cj, t))(jparams, toks)
    with ops.kernel_policy(MODES[mode]):
        got = TT.forward(tparams, ct, torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, 11, K, ct.vocab_size)
    assert_close(jax_results["forward"], got, tol("f32"), f"forward {mode}")


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_rect_prefill_matches_jax(model, jax_results, mode):
    """Two prompts of 13 real frames right-padded to 16 into a rectangular
    cache of 24 rows: the logits (B, 1, K, V) at the last real frame and
    every k / v row."""
    cj, ct, _, jparams, tparams = model
    toks = frames(ct, (2, 16), 4)
    if "prefill" not in jax_results:
        jax_results["prefill"] = jax.jit(lambda p, t: JT.prefill(
            p, cj, t, JT.init_cache(cj, 2, 24), last_idx=12))(jparams, toks)
    want, jcache = jax_results["prefill"]
    with ops.kernel_policy(MODES[mode]):
        got, tcache = TT.prefill(tparams, ct, torch.from_numpy(toks).long(),
                                 TT.init_cache(ct, 2, 24, "cpu"), last_idx=12)
    assert tuple(got.shape) == (2, 1, K, ct.vocab_size)
    assert_close(want, got, tol("f32"), f"prefill logits {mode}")
    for leaf in ("k", "v"):
        assert_close(jcache["layers"][leaf], tcache["layers"][leaf],
                     tol("f32"), f"prefill {leaf} {mode}")


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_decode_matches_jax(model, jax_results, mode):
    """One paged decode step of three slots (ragged tables, slot 2
    inactive: all-null) fed (B, 1, K) frames over random pages: logits and
    the mapped pages equal JAX's ``decode_step``."""
    cj, ct, _, jparams, tparams = model
    rng = np.random.default_rng(5)
    pool = {leaf: rng.standard_normal((ct.n_layers, 10, PS, ct.n_kv_heads,
                                       ct.head_dim)).astype(np.float32)
            for leaf in ("k", "v")}
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([11, 6, 2], np.int32)
    tok = frames(ct, (3, 1), 6)
    if "decode" not in jax_results:
        jcache = {"layers": {k: jnp.asarray(v) for k, v in pool.items()}}
        jax_results["decode"] = jax.jit(lambda p, t, c, q, b: JT.decode_step(
            p, cj, t, c, q, block_tables={"linear": b}))(
                jparams, tok, jcache, pos, bt)
    want, jc = jax_results["decode"]
    tc = {"layers": {k: torch.from_numpy(v.copy()) for k, v in pool.items()}}
    params = tparams if mode == "ref" else \
        tsurgery.merge_projection_groups(tparams)
    with ops.kernel_policy(MODES[mode]):
        got, tc = TT.decode_step(params, ct, torch.from_numpy(tok).long(), tc,
                                 torch.from_numpy(pos).long(),
                                 block_tables={"linear": torch.from_numpy(bt)})
    assert tuple(got.shape) == (3, 1, K, ct.vocab_size)
    assert_close(want[:2], got[:2], tol("f32"), f"decode logits {mode}")
    for leaf in ("k", "v"):
        # page 0 is the inactive slot's trash
        assert_close(jc["layers"][leaf][:, 1:], tc["layers"][leaf][:, 1:],
                     tol("f32"), f"decode pool {leaf} {mode}")


def test_sample_token_per_codebook():
    """Greedy: (B, 1, K, V) logits give (B, K) ids equal to JAX's. Sampled
    (temperature 0.8, top-k 5): each codebook's draw lies inside that
    codebook's top 5 (the two packages' random streams differ)."""
    lg = np.random.default_rng(7).standard_normal((3, 1, K, 50)
                                                  ).astype(np.float32)
    want = jsample_token(jnp.asarray(lg), jax.random.PRNGKey(0),
                         JServeConfig(greedy=True))
    got = sample_token(torch.from_numpy(lg), None, ServeConfig(greedy=True))
    assert tuple(got.shape) == (3, K)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    gen = torch.Generator().manual_seed(0)
    top = np.argsort(-lg[:, 0], axis=-1)[..., :5]
    for _ in range(20):
        got = sample_token(torch.from_numpy(lg), gen,
                           ServeConfig(temperature=0.8, top_k=5)).numpy()
        assert got.shape == (3, K)
        assert all(got[b, k] in top[b, k] for b in range(3) for k in range(K))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# mid-flight admissions into reused slots (2 slots for 4 requests); the
# last request ends on EOS: codebook 0 of its third frame (EOS_AT)
LENS, BUDGETS = [5, 9, 3, 12], [6, 8, 5, 7]
EOS_AT = 2


def _serve(request, eng, prompts, budgets, eos=None, midflight=True):
    """Submit every prompt to `eng` (either package's), the first two up
    front and the rest after one step; `eos` {uid: eos_id}. Drains it."""
    eos = eos or {}
    for uid, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(request(uid, p, max_new_tokens=b, eos_id=eos.get(uid)))
        if midflight and uid == 1:
            eng.step()
    return {u: np.asarray(r.output) for u, r in eng.run().items()}


def _port_engine(ct, tparams, mode, max_batch=2, max_len=48, **kw):
    return InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True,
                                                    page_size=PS, **kw),
                           max_batch=max_batch, max_len=max_len,
                           device="cpu", policy=MODES[mode])


def _drained(eng):
    assert not eng.kv.ref.any(), "a drained engine maps no page"
    assert eng.kv.used_pages == eng.kv.cached_page_count
    assert not eng.kv.tables["linear"].any()
    assert not eng.active.any() and not eng.scheduler.pending
    eng.check_invariants()
    if eng.prefix is not None:
        eng.prefix.clear()
    assert eng.kv.used_pages == 0


@pytest.fixture(scope="module")
def trace(model):
    """The engine trace: prompts, budgets and the EOS request's eos_id,
    codebook 0 of the frame the undisturbed port engine emits at EOS_AT
    for the last request."""
    _, ct, _, _, tparams = model
    prompts = prompts_of(ct, LENS, seed=8)
    free = _serve(Request, _port_engine(ct, tparams, "ref"), prompts,
                  BUDGETS)
    last = len(LENS) - 1
    return prompts, free, {last: int(free[last][EOS_AT, 0])}


@pytest.fixture(scope="module")
def jax_engine_run(model, trace):
    """JAX's engine (prefix cache on, its default) on the trace: frames,
    admission steps, and whether it built a prefix index."""
    cj, _, _, jparams, _ = model
    prompts, _, eos = trace
    eng = JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS),
                  max_batch=2, max_len=48)
    got = _serve(JRequest, eng, prompts, BUDGETS, eos)
    return got, dict(eng.admission_step), eng.prefix is not None


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(model, trace, jax_engine_run, mode,
                                   prefix):
    """Frames (n, 4) identical to JAX's engine's on every mode, with the
    port's prefix cache on and off; the EOS request stops at the first
    frame whose codebook 0 is its eos_id (no later than EOS_AT), in both
    packages; admission steps equal; both packages index prefixes of
    audio prompts when the cache is on; the pool drained."""
    _, ct, _, _, tparams = model
    prompts, free, eos = trace
    want, jsteps, jprefix = jax_engine_run
    eng = _port_engine(ct, tparams, mode, prefix_cache=prefix)
    assert (eng.prefix is not None) == prefix and jprefix
    got = _serve(Request, eng, prompts, BUDGETS, eos)
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].shape == (len(want[u]), K)
        np.testing.assert_array_equal(want[u], got[u], err_msg=f"uid {u}")
    last = len(LENS) - 1
    n = len(got[last])
    assert n <= EOS_AT + 1 < BUDGETS[last]
    assert got[last][-1, 0] == eos[last]
    np.testing.assert_array_equal(got[last], free[last][:n])
    assert eng.admission_step == jsteps
    assert eng.stats["tokens_emitted"] == sum(len(v) for v in got.values())
    _drained(eng)


@pytest.mark.parametrize("mode", list(MODES))
def test_rect_engine_matches_jax_engine(model, trace, jax_engine_run, mode):
    """``ServeConfig(paged=False)``: frames identical to JAX's engine's
    (its pool, whose tokens the reference holds equal to its
    rectangle's), the EOS request stopping where it does there, admission
    steps equal, no pool and no prefix index; every layer's k / v
    rectangle of 2 slots x 48 frames."""
    cj, ct, _, jparams, tparams = model
    prompts, _, eos = trace
    want, jsteps, _ = jax_engine_run
    eng = _port_engine(ct, tparams, mode, paged=False)
    assert eng.kv is None and eng.prefix is None
    got = _serve(Request, eng, prompts, BUDGETS, eos)
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u], err_msg=f"uid {u}")
    assert eng.admission_step == jsteps
    assert eng.kv_cache_bytes() == (ct.n_layers * 2 * 2 * 48
                                    * ct.n_kv_heads * ct.head_dim * 4)


def _shared_trace(ct):
    """A 2-page system prompt of frames under 3 tails (one of a whole
    page), a repeat of a prompt (a full cover: its last page copied on
    write), the system prompt alone and an unshared prompt."""
    sys_p = prompts_of(ct, [2 * PS], seed=10)[0]
    tails = prompts_of(ct, [3, PS, 2], seed=11)
    out = [np.concatenate([sys_p, t]) for t in tails]
    out += [out[1].copy(), sys_p.copy(), prompts_of(ct, [6], seed=12)[0]]
    return out, [5, 6, 4, 5, 4, 5]


@pytest.fixture(scope="module")
def jax_shared_run(model):
    cj, ct, _, jparams, _ = model
    prompts, budgets = _shared_trace(ct)
    eng = JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS),
                  max_batch=3, max_len=32)
    got = _serve(JRequest, eng, prompts, budgets)
    return got, dict(eng.stats), dict(eng.admission_step)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_shared_prefix_matches_jax_prefix_engine(model, jax_shared_run,
                                                 mode):
    """Prompts sharing a prefix of (page_size, 4) frame chunks: the port's
    index hits where JAX's does, copies on write as often, and the frames
    equal JAX's prefix engine's and the port's unshared engine's."""
    _, ct, _, _, tparams = model
    prompts, budgets = _shared_trace(ct)
    want, jstats, jsteps = jax_shared_run
    eng = _port_engine(ct, tparams, mode, max_batch=3, max_len=32)
    got = _serve(Request, eng, prompts, budgets)
    plain = _serve(Request, _port_engine(ct, tparams, mode, max_batch=3,
                                         max_len=32, prefix_cache=False),
                   prompts, budgets)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u], err_msg=f"uid {u}")
        np.testing.assert_array_equal(plain[u], got[u], err_msg=f"uid {u}")
    assert {k: eng.stats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}
    assert eng.admission_step == jsteps
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.stats["cow_copies"] >= 1 and eng.stats["shared_pages"] > 0
    _drained(eng)


DRAIN_LENS = [6, 9, 4]


@pytest.fixture(scope="module")
def undisturbed(model):
    _, ct, _, _, tparams = model
    return _serve(Request, _port_engine(ct, tparams, "ref"),
                  prompts_of(ct, DRAIN_LENS, seed=13), [8, 8, 8],
                  midflight=False)


@pytest.mark.parametrize("src,dest", [("port", "port"), ("port", "jax"),
                                      ("jax", "port")])
def test_drain_snapshot_restore(model, undisturbed, tmp_path, src, dest):
    """``drain(timeout=0)`` after 3 steps preempts the live slots; the
    snapshot (emitted (4,) frames as lists) written by either package
    restores into a fresh engine of either package, whose resume
    re-prefills the prompt with the emitted frames stacked under it, and
    every request ends with the undisturbed engine's frames."""
    cj, ct, _, jparams, tparams = model
    prompts = prompts_of(ct, DRAIN_LENS, seed=13)

    def engine(pkg):
        if pkg == "port":
            return _port_engine(ct, tparams, "kernels"), Request, recovery
        return (JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS),
                        max_batch=2, max_len=48), JRequest, jrecovery)
    eng, request, rec = engine(src)
    for u, p in enumerate(prompts):
        eng.submit(request(u, p, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    before = dict(eng.drain(timeout=0))
    # the preempted slots' pages are released; the index keeps its own
    assert eng.stats["preemptions"] == 2 and not eng.kv.ref.any()
    path = os.path.join(str(tmp_path), "snap.json")
    rec.save_snapshot(eng, path)
    dst, _, rec = engine(dest)
    restored = rec.restore(dst, rec.load_snapshot(path))
    assert set(restored) | set(before) == {0, 1, 2}
    for h in restored.values():
        assert all(np.shape(t) == (K,) for t in h.tokens)
    after = dst.run()
    for u in undisturbed:
        out = np.asarray((before.get(u) or after[u]).output)
        np.testing.assert_array_equal(out, undisturbed[u], err_msg=f"uid {u}")
    if dest == "port":
        _drained(dst)


def test_speculative_refusal_matches_jax(model):
    """A speculative engine on audio raises JAX's error, at the point of
    the reference's checks where audio is refused."""
    cj, ct, _, jparams, tparams = model
    kw = dict(greedy=True, page_size=PS, spec_rank_frac=0.5)
    with pytest.raises(ValueError) as want:
        JEngine(jparams, cj, JServeConfig(**kw), max_batch=2, max_len=48)
    with pytest.raises(ValueError) as got:
        InferenceEngine(tparams, ct, ServeConfig(**kw), max_batch=2,
                        max_len=48, device="cpu")
    assert "multi-codebook audio" in str(want.value)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# generate, artifacts, the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_generate(model):
    cj, ct, _, jparams, _ = model
    toks = frames(ct, (3, 7), 14)
    gen, logits = jgenerate(jparams, cj, jnp.asarray(toks),
                            JServeConfig(greedy=True, max_new_tokens=5))
    return toks, np.asarray(gen), np.asarray(logits, np.float32)


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_matches_jax(model, jax_generate, mode):
    """``generate`` of 3 prompts of 7 frames, 5 new: (3, 5, 4) frames equal
    to JAX's ``generate`` and its last logits (3, 1, 4, V) within the
    tolerance; ``api.NanoQuantModel.generate`` gives the same frames
    through the engine."""
    _, ct, tree, _, tparams = model
    toks, want, wl = jax_generate
    got, logits = generate(tparams, ct, toks,
                           ServeConfig(greedy=True, max_new_tokens=5,
                                       page_size=PS), policy=MODES[mode])
    assert got.dtype == torch.long and tuple(got.shape) == (3, 5, K)
    assert tuple(logits.shape) == (3, 1, K, ct.vocab_size)
    np.testing.assert_array_equal(want, got.numpy())
    assert_close(wl, logits, tol("f32"), f"generate logits {mode}")
    if mode == "ref":
        m = NanoQuantModel(tparams, ct)
        outs = m.generate(list(toks), max_new_tokens=5,
                          scfg=ServeConfig(greedy=True, max_new_tokens=5,
                                           page_size=PS), max_batch=2)
        np.testing.assert_array_equal(want, np.stack(outs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifacts_cross_the_packages(tmp_path, dtype):
    """A JAX-saved audio artifact loads leaf for leaf in the port (the
    (4, V, d) embedding among the leaves), and the port's ``save`` of it
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
    assert tuple(m.params["embed"].shape) == (K, ct.vocab_size, ct.d_model)
    m.save(str(tmp_path / "port"))
    back = japi.NanoQuantModel.load(str(tmp_path / "port"))
    leaves_equal(jparams, back.params)


def _cli(*args):
    # the CLI quantizes its demo teacher first: one thread, as the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, *args], capture_output=True, text=True, env=env,
        timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_serve_cli_serves_audio():
    """``python -m repro_torch.launch.serve --arch musicgen-medium``
    quantizes the smoke teacher on the CPU (the demo, in the config's
    bf16) and serves it: prompts of 6 frames, 4 frames each, a pool of 2
    layers x 2 leaves x 4 kv heads x 16 x 2 bytes = 512 bytes per
    token."""
    out = _cli("--requests", "3", "--prompt-len", "6", "--max-new", "4",
               "--max-batch", "2", "--page-size", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "musicgen-medium-smoke (bfloat16) teacher from seed 0" in \
        out.stdout
    assert "[serve] quantized random-init teacher (demo)" in out.stdout
    assert "3 requests, 12 tokens" in out.stdout
    assert "512 bytes per token" in out.stdout


def test_serve_cli_refuses_a_shared_prefix_for_audio():
    out = _cli("--requests", "2", "--prompt-len", "4", "--max-new", "2",
               "--shared-prefix", "8")
    assert out.returncode == 2
    assert "--shared-prefix does not support audio prompts" in out.stderr
