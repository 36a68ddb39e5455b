"""The qwen1.5 slice of the port against the JAX reference, on the CPU.

qwen1.5-110b is the model whose MLP ranks (6976 at 1.0 bpw) pass
``MAX_FUSED_RANK``, so it runs the two-call route; it also has QKV
biases (so the decode megakernel does not qualify), rope_theta 1e6 and
an untied lm head. At smoke size the ranks are small, so these tests
lower ``MAX_FUSED_RANK`` in both packages' ``binary_matmul`` modules:
to 64, attention stays fused and the MLP takes the two-call route, as at
full size; to 16, every packed linear does. The smoke model is packed at
3.0 bpw with ``min_dim=8`` so that wk / wv are packed too and the merged
QKV group (with its per-projection biases) has ragged ranks (64, 32,
32) under an rmask. Everything is f32: logits within 1e-4 (relative
max-abs, as ``test_torch_model.py``), greedy tokens identical."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_common import assert_close, f32, jax_tree, torch_params
from repro import configs as jconfigs
from repro.kernels import binary_matmul as jbm
from repro.models import transformer as JT
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.kernels import binary_matmul, megakernel, ops, paged_attention
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.testing import random_packed_params

ARCH = "qwen1.5-110b"
LOGITS_TOL = 1e-4
LENS, BUDGETS = [5, 11, 3, 8], [6, 4, 7, 5]
# (policy, MAX_FUSED_RANK in both packages)
ROUTES = {"mlp-twocall": (ops.KernelPolicy(mode="cuda"), 64),
          "all-twocall": (ops.KernelPolicy(mode="cuda"), 16),
          "unfused": (ops.KernelPolicy(mode="cuda", fused=False), 4096)}


@pytest.fixture(scope="module")
def model():
    cfg = f32(jconfigs.get_smoke(ARCH))
    tree = random_packed_params(
        tsurgery.abstract_quantized_params(cfg, 3.0, min_dim=8), seed=0)
    return cfg, jax_tree(tree), torch_params(tree)


def _route(monkeypatch, name):
    pol, threshold = ROUTES[name]
    monkeypatch.setattr(jbm, "MAX_FUSED_RANK", threshold)
    monkeypatch.setattr(binary_matmul, "MAX_FUSED_RANK", threshold)
    return pol


def _counting(monkeypatch, calls):
    for mod, name in ((binary_matmul, "packed_matmul"),
                      (binary_matmul, "fused_lowrank_matmul_grouped"),
                      (paged_attention, "paged_decode_attention"),
                      (megakernel, "decode_step_megakernel_raw")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)


def test_smoke_model_has_the_full_size_layout(model):
    cfg, _, tparams = model
    assert cfg.qkv_bias and cfg.rope_theta == 1e6 and not cfg.tie_embeddings
    attn = tparams["layers"]["attn"]
    assert all("b" in attn[k] and "qu_t" in attn[k] for k in ("wq", "wk",
                                                             "wv"))
    ranks = [attn[k]["qv"].shape[-1] for k in ("wq", "wk", "wv", "wo")]
    assert ranks == [64, 32, 32, 64]
    assert tparams["layers"]["ffn"]["w_down"]["qv"].shape[-1] == 128
    merged = tsurgery.merge_projection_groups(tparams)["layers"]["attn"]
    assert merged["wqkv"]["b"].shape == (cfg.n_layers, 3, cfg.n_heads
                                         * cfg.head_dim)


@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_matches_jax(model, monkeypatch, route):
    """Biases, theta 1e6 and the untied head through every route."""
    cfg, jparams, tparams = model
    pol = _route(monkeypatch, route)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    want = jax.jit(lambda p, t: JT.forward(p, cfg, t))(jparams, toks)
    if pol.use_merged_projections("cpu"):
        tparams = tsurgery.merge_projection_groups(tparams)
    calls = {}
    _counting(monkeypatch, calls)
    with ops.kernel_policy(pol):
        got = TT.forward(tparams, cfg, torch.from_numpy(toks).long())
    assert_close(want, got, LOGITS_TOL, f"qwen forward ({route})")
    assert calls["packed_matmul"] > 0
    assert ("fused_lowrank_matmul_grouped" in calls) == (route ==
                                                         "mlp-twocall")


@pytest.fixture(scope="module")
def jax_tokens(model):
    cfg, jparams, _ = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in LENS]
    eng = JEngine(jparams, cfg, JServeConfig(greedy=True, page_size=8),
                  max_batch=2, max_len=32)
    for uid, (p, b) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(JRequest(uid, p, max_new_tokens=b))
    return prompts, {u: r.output for u, r in eng.run().items()}


@pytest.mark.parametrize("route", list(ROUTES))
def test_engine_matches_jax_engine(model, jax_tokens, monkeypatch, route):
    """Greedy tokens of the port's engine on the kernel path (plain
    versions on the CPU) equal the JAX engine's, with mid-flight
    admission; the two-call kernel runs, the megakernel never does (QKV
    biases), and the fused kernel only where ranks fit it."""
    cfg, _, tparams = model
    prompts, want = jax_tokens
    pol = _route(monkeypatch, route)
    calls = {}
    _counting(monkeypatch, calls)
    eng = InferenceEngine(tparams, cfg, ServeConfig(greedy=True, page_size=8,
                                                    debug=True),
                          max_batch=2, max_len=32, device="cpu", policy=pol)
    for uid, (p, b) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(Request(uid, p, max_new_tokens=b))
    got = {u: r.output for u, r in eng.run().items()}
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
    assert eng.admission_step[2] > 0 and not eng.kv.ref.any()
    assert eng.kv.used_pages == eng.kv.cached_page_count
    assert calls["packed_matmul"] > 0 and calls["paged_decode_attention"] > 0
    assert "decode_step_megakernel_raw" not in calls
    assert ("fused_lowrank_matmul_grouped" in calls) == (route ==
                                                         "mlp-twocall")


def test_full_size_ranks():
    """qwen1.5-110b at 1.0 bpw: wq / wo fit the fused kernel, the MLP's
    ranks pass MAX_FUSED_RANK."""
    cfg = tconfigs.get_config(ARCH)
    t = tsurgery.abstract_quantized_params(cfg)
    ranks = {k: t["layers"][blk][k]["qv"].shape[-1]
             for blk, ks in (("attn", ("wq", "wk", "wv", "wo")),
                             ("ffn", ("w_gate", "w_up", "w_down")))
             for k in ks}
    assert ranks == {"wq": 4064, "wo": 4064, "wk": 864, "wv": 864,
                     "w_gate": 6976, "w_up": 6976, "w_down": 6976}
    assert max(ranks["wq"], ranks["wo"]) <= binary_matmul.MAX_FUSED_RANK \
        < ranks["w_gate"]
    assert dataclasses.asdict(cfg)["qkv_bias"] and not cfg.tie_embeddings
