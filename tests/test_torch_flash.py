"""The port's ``sdpa_flash`` (``repro_torch.models.layers``) against the JAX
package's and against the port's plain ``sdpa``.

``sdpa_flash`` is the reference's memory-bounded attention (query chunks
outside, key chunks inside with an online softmax), plain PyTorch ops in
the port; a model dispatches it at ``S >= cfg.flash_threshold`` in the
cache-less forward and the rectangular prefill, after the GQA head
repeat. The thresholds and chunks are lowered here so that smoke shapes
take that route. Outputs and gradients in f32 within 1e-5 relative
max-abs (``tests/test_kernel_diff.py::_tol``); the engine's greedy tokens
equal those of the plain route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, f32, one_torch_thread,  # noqa: F401
                           packed_model, tol, torch_params)
from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.data import SyntheticCorpus, make_batch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.train.loop import _value_and_grad

B, S, HQ, D = 2, 48, 4, 8
LOW = dict(flash_threshold=16, flash_q_chunk=8, flash_kv_chunk=8)


def _qkv(hkv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, HQ, D)).astype(np.float32),
            rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, HQ, D)).astype(np.float32))


@pytest.mark.parametrize("hkv,window,chunks", [
    (4, 0, (16, 8)), (2, 0, (16, 8)), (2, 20, (8, 16)), (1, 12, (48, 8))])
def test_sdpa_flash_matches_jax_and_plain(hkv, window, chunks):
    """Output and the q / k / v gradients of a random cotangent: the port's
    flash against JAX's flash and against the port's plain ``sdpa`` with
    the causal (+ window) mask, grouped heads included."""
    q, k, v, ct = _qkv(hkv)
    scale = 1.0 / np.sqrt(D)
    pos = np.arange(S)

    def jf(q, k, v):
        return JL.sdpa_flash(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                             scale, window, *chunks)
    jo, jvjp = jax.vjp(jf, q, k, v)
    jg = jvjp(jnp.asarray(ct))
    tpos = torch.arange(S)
    outs = {}
    for name in ("flash", "plain"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        if name == "flash":
            o = TL.sdpa_flash(tq, tk, tv, tpos, tpos, scale, window, *chunks)
        else:
            o = TL.sdpa(tq, tk, tv, TL._mask(tpos, tpos, window), scale)
        g = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(ct))
        outs[name] = (o, g)
    o, g = outs["flash"]
    assert_close(jo, o, tol("f32"), "flash vs JAX's flash")
    assert_close(outs["plain"][0], o, tol("f32"), "flash vs plain")
    for n, a, b, c in zip("qkv", jg, g, outs["plain"][1]):
        assert_close(a, b, tol("f32"), f"d{n} vs JAX's flash")
        assert_close(c, b, tol("f32"), f"d{n} vs plain")


def test_sdpa_flash_chunks():
    """Chunks past the length are cut to it; a length that is not a
    multiple of its chunk refuses; without a gradient no key chunk is
    checkpointed, with one each is."""
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(2))
    pos = torch.arange(S)
    want = TL.sdpa_flash(q, k, v, pos, pos, 0.3, 0, 16, 8)
    got = TL.sdpa_flash(q, k, v, pos, pos, 0.3, 0, 512, 1024)
    assert_close(want, got, tol("f32"), "one chunk")
    with pytest.raises(ValueError, match="multiples"):
        TL.sdpa_flash(q, k, v, pos, pos, 0.3, 0, 32, 8)
    calls = []
    real = TL.checkpoint
    try:
        TL.checkpoint = lambda f, *a, **kw: calls.append(1) or real(
            f, *a, **kw)
        with torch.no_grad():
            TL.sdpa_flash(q, k, v, pos, pos, 0.3, 0, 16, 8)
        assert not calls
        TL.sdpa_flash(q.requires_grad_(), k, v, pos, pos, 0.3, 0, 16, 8)
        assert len(calls) == (S // 16) * (S // 8)
    finally:
        TL.checkpoint = real


def _spy_flash(monkeypatch):
    calls = []
    real = TL.sdpa_flash
    monkeypatch.setattr(TL, "sdpa_flash",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    return calls


@pytest.fixture(scope="module")
def smoke():
    """(JAX's and the port's params of llama3.2-1b's and zamba2-1.2b's
    smoke configs in f32, JAX's init)."""
    out = {}
    for arch in ("llama3.2-1b", "zamba2-1.2b"):
        cfg = f32(jconfigs.get_smoke(arch))
        jp = jax.jit(lambda k: JT.init_params(k, cfg))(jax.random.PRNGKey(0))
        out[arch] = (jp, torch_params(jax.tree.map(np.asarray, jp)))
    return out


@pytest.mark.parametrize("arch,window", [("llama3.2-1b", 0),
                                         ("llama3.2-1b", 12),
                                         ("zamba2-1.2b", 12)])
def test_forward_dispatches_flash(arch, window, smoke, monkeypatch):
    """The cache-less forward at S 32 over a lowered threshold of 16: the
    port's logits within 1e-5 of JAX's (the same lowered config) and of
    the port's plain route, every attention layer (the hybrid's shared
    block at each application) through ``sdpa_flash`` at Hq heads."""
    jparams, tparams = smoke[arch]
    base = f32(jconfigs.get_smoke(arch))
    cfg = dataclasses.replace(base, sliding_window=window, **LOW)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    want = jax.jit(lambda p, t: JT.forward(p, cfg, t))(jparams, toks)
    calls = _spy_flash(monkeypatch)
    got = TT.forward(tparams, cfg, torch.from_numpy(toks).long())
    n_attn = (TT.n_shared_apps(cfg) if cfg.family == "hybrid"
              else cfg.n_layers)
    assert len(calls) == n_attn
    assert all(s[2] == cfg.n_heads for s in calls)
    assert_close(want, got, tol("f32"), "forward vs JAX")
    plain = TT.forward(tparams, dataclasses.replace(base,
                                                    sliding_window=window),
                       torch.from_numpy(toks).long())
    assert len(calls) == n_attn
    assert_close(plain, got, tol("f32"), "flash vs plain forward")


def test_prefill_dispatches_flash(smoke, monkeypatch):
    """The rectangular prompt prefill of 16 tokens at the lowered
    threshold: the last real token's logits and the cache rows against
    JAX's prefill of the same config."""
    jparams, tparams = smoke["llama3.2-1b"]
    cfg = dataclasses.replace(f32(jconfigs.get_smoke("llama3.2-1b")), **LOW)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 16)).astype(np.int32)
    want, jcache = jax.jit(lambda p, t: JT.prefill(
        p, cfg, t, JT.init_cache(cfg, 1, 24), last_idx=12))(jparams, toks)
    calls = _spy_flash(monkeypatch)
    got, tcache = TT.prefill(tparams, cfg, torch.from_numpy(toks).long(),
                             TT.init_cache(cfg, 1, 24, "cpu"), last_idx=12)
    assert len(calls) == cfg.n_layers
    assert_close(want, got, tol("f32"), "prefill logits")
    for leaf in ("k", "v"):
        assert_close(jcache["layers"][leaf], tcache["layers"][leaf],
                     tol("f32"), f"prefill cache {leaf}")


def test_training_gradients_through_flash(smoke):
    """A training step's loss and gradients (remat on, so each key chunk
    is recomputed inside each recomputed layer) through the flash route
    within 1e-5 of the plain route's."""
    _, tparams = smoke["llama3.2-1b"]
    base = dataclasses.replace(f32(jconfigs.get_smoke("llama3.2-1b")),
                               remat=True)
    batch = make_batch(base, SyntheticCorpus(base.vocab_size), 0, 0, 2, 32)
    l0, g0 = _value_and_grad(base, tparams, batch)
    l1, g1 = _value_and_grad(dataclasses.replace(base, **LOW), tparams, batch)
    assert_close(l0, l1, tol("f32"), "loss")
    from repro_torch.core import util
    for (path, a), b in zip(util.leaves_with_path(g0), util.leaves(g1)):
        assert_close(a, b, tol("f32"), path)


def test_engine_tokens_unchanged_over_threshold(monkeypatch):
    """The port's engine (a packed smoke model in f32) on prompts whose
    prefill buckets (32) pass the lowered threshold: greedy tokens equal
    those of the same engine on the plain route."""
    base = f32(jconfigs.get_smoke("llama3.2-1b"))
    tparams = torch_params(packed_model(base, seed=0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab_size, size=(n,)).astype(np.int32)
               for n in (20, 5, 27)]
    outs = []
    for cfg in (base, dataclasses.replace(base, **LOW)):
        calls = _spy_flash(monkeypatch)
        eng = InferenceEngine(tparams, cfg, ServeConfig(greedy=True), 2, 48,
                              device="cpu")
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=6))
        outs.append({u: list(r.output) for u, r in eng.run().items()})
        outs.append(len(calls))
    assert outs[1] == 0 and outs[3] == 2 * base.n_layers
    assert outs[0] == outs[2]
