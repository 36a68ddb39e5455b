"""The port's serving engine against the JAX reference engine.

Both engines serve the same packed smoke model (f32, so greedy argmax is
decided by the math and not by rounding) on the same request trace; the
port runs on the CPU in two dispatch structures — the plain oracles
(``mode="ref"``) and the kernel wrappers' plain versions behind merged
projections and the decode megakernel (``mode="cuda"`` on CPU tensors) —
and must emit the reference's greedy tokens exactly, including
mid-flight admission and a forced preemption with re-prefill."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import f32, jax_tree, packed_model, torch_params
from repro import configs as jconfigs
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.api import NanoQuantModel
from repro_torch.kernels import binary_matmul, megakernel, ops, paged_attention
from repro_torch.serve.engine import InferenceEngine, ServeConfig, sample_token
from repro_torch.serve.scheduler import Request, bucket_length

LENS, BUDGETS = [3, 9, 17, 5, 12], [6, 3, 5, 8, 4]
MODES = {"ref": ops.KernelPolicy(mode="ref"),
         "kernels": ops.KernelPolicy(mode="cuda"),
         "kernels-no-mega": ops.KernelPolicy(mode="cuda", megakernel=False)}


@pytest.fixture(scope="module")
def model():
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    tree = packed_model(cfg, seed=0)
    return cfg, tree, jax_tree(tree), torch_params(tree)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in lens]


def _run_jax(jparams, cfg, prompts, budgets, scfg, max_batch, max_len):
    eng = JEngine(jparams, cfg, scfg, max_batch=max_batch, max_len=max_len)
    for uid, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(JRequest(uid, p, max_new_tokens=b))
    return {u: r.output for u, r in eng.run().items()}, eng


def _run_port(tparams, cfg, prompts, budgets, scfg, max_batch, max_len,
              policy):
    eng = InferenceEngine(tparams, cfg, scfg, max_batch=max_batch,
                          max_len=max_len, device="cpu", policy=policy)
    for uid, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(Request(uid, p, max_new_tokens=b))
    return {u: r.output for u, r in eng.run().items()}, eng


@pytest.fixture(scope="module")
def jax_midflight(model):
    cfg, _, jparams, _ = model
    prompts = _prompts(cfg, LENS)
    out, _ = _run_jax(jparams, cfg, prompts, BUDGETS,
                      JServeConfig(greedy=True, page_size=8), 2, 40)
    return prompts, out


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("mode", list(MODES))
def test_midflight_admission_matches_jax_engine(model, jax_midflight, mode,
                                                monkeypatch):
    cfg, _, _, tparams = model
    prompts, want = jax_midflight
    calls = {}
    _spy(monkeypatch, binary_matmul, "fused_lowrank_matmul_grouped", calls)
    _spy(monkeypatch, paged_attention, "paged_decode_attention", calls)
    _spy(monkeypatch, megakernel, "decode_step_megakernel_raw", calls)
    got, eng = _run_port(tparams, cfg, prompts, BUDGETS,
                         ServeConfig(greedy=True, page_size=8, debug=True),
                         2, 40, MODES[mode])
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
    assert eng.stats["admissions"] == len(LENS)
    assert eng.admission_step[2] > 0           # admitted mid-flight
    assert eng.kv.used_pages == 0
    if mode == "ref":
        assert not calls
    else:
        assert calls["fused_lowrank_matmul_grouped"] > 0
        assert ("decode_step_megakernel_raw" in calls) == (mode == "kernels")
        assert ("paged_decode_attention" in calls) == (mode != "kernels")


def test_forced_preemption_matches_jax_engine(model):
    """Two slots admitted cheap, then both grow: the pool runs dry
    mid-decode, the younger slot is preempted and re-prefilled, and the
    tokens still match the reference engine's."""
    cfg, _, jparams, tparams = model
    prompts = _prompts(cfg, [4, 4], seed=7)
    kw = dict(greedy=True, page_size=4, kv_pool_pages=9, prefix_cache=False)
    want, jeng = _run_jax(jparams, cfg, prompts, [24, 24],
                          JServeConfig(**kw), 2, 32)
    got, eng = _run_port(tparams, cfg, prompts, [24, 24],
                         ServeConfig(**kw, debug=True), 2, 32,
                         MODES["kernels"])
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] >= 1
    assert eng.admission_step == jeng.admission_step
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
    assert eng.kv.used_pages == 0
    eng.check_invariants()


def test_streaming_callbacks_and_eos(model):
    cfg, _, _, tparams = model
    prompts = _prompts(cfg, [5, 6], seed=3)
    eng = InferenceEngine(tparams, cfg, ServeConfig(greedy=True), 2, 24,
                          device="cpu")
    free = eng.submit(Request(0, prompts[0], max_new_tokens=6))
    seen = []
    full = list(free)                          # streams, pumping step()
    assert full == free.tokens and free.done and len(full) == 6
    eos = full[2]
    h = eng.submit(Request(1, prompts[0], max_new_tokens=6, eos_id=eos),
                   on_token=lambda uid, t: seen.append((uid, t)))
    out = h.result()
    assert list(out) == full[:full.index(eos) + 1]
    assert seen == [(1, t) for t in out]
    assert h.ttft is not None and h.latency >= h.ttft


def test_submit_validation_and_unported_options(model):
    cfg, _, _, tparams = model
    eng = InferenceEngine(tparams, cfg, ServeConfig(greedy=True), 2, 16,
                          device="cpu")
    for bad in (np.zeros(0, np.int32), np.zeros(16, np.int32),
                np.array([cfg.vocab_size], np.int32)):
        with pytest.raises(ValueError):
            eng.submit(Request(0, bad))
    eng.submit(Request(0, np.ones(3, np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(Request(0, np.ones(3, np.int32)))
    spec = InferenceEngine(tparams, cfg, ServeConfig(
        greedy=True, spec_rank_frac=0.5), device="cpu")
    assert spec.spec is not None and spec.spec.k == spec.scfg.spec_k
    with pytest.raises(ValueError, match="greedy"):
        InferenceEngine(tparams, cfg, ServeConfig(spec_rank_frac=0.5),
                        device="cpu")
    with pytest.raises(NotImplementedError):
        InferenceEngine(tparams, cfg, ServeConfig(paged=False), device="cpu")
    with pytest.raises(ValueError, match="cannot hold one slot"):
        InferenceEngine(tparams, cfg, ServeConfig(kv_pool_pages=1), 2, 16,
                        device="cpu")
    assert bucket_length(17, 256) == 32 and bucket_length(200, 256) == 256


def test_sampling_is_seeded(model):
    cfg, tree, _, _ = model
    m = NanoQuantModel.from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(cfg, [4, 7], seed=9)
    scfg = ServeConfig(temperature=1.0, top_k=16, max_new_tokens=5)
    a = m.generate(prompts, scfg=scfg, seed=1)
    b = m.generate(prompts, scfg=scfg, seed=1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    logits = torch.randn(3, 1, 50, generator=torch.Generator().manual_seed(0))
    top = torch.topk(logits[:, -1], 4).indices
    g = torch.Generator().manual_seed(2)
    for _ in range(20):
        tok = sample_token(logits, g, dataclasses.replace(scfg, top_k=4))
        assert all(int(t) in top[i].tolist() for i, t in enumerate(tok[:, 0]))
    greedy = sample_token(logits, None, ServeConfig(greedy=True))
    assert greedy[:, 0].tolist() == logits[:, -1].argmax(-1).tolist()


def test_page_allocator_and_slot_ops():
    from repro_torch.serve import paging
    from repro_torch.serve.scheduler import (SlotScheduler,
                                             cache_insert_slot,
                                             cache_select_active,
                                             pick_preemption_victim)
    kv = paging.PagedKVState(max_batch=2, max_len=10, page_size=4, n_pages=5)
    assert kv.lin_pages == 3 and kv.free_pages == 4
    ids = kv.admit(0, 5)["linear"]
    assert list(ids) == [1, 2, 0] and kv.used_pages == 2
    assert kv.ensure(0, 8) and kv.tables["linear"][0, 2] == 3
    assert kv.admit(1, 3)["linear"][0] == 4 and not kv.ensure(1, 4)
    kv.check_invariants()
    kv.ref[4] = 2
    with pytest.raises(paging.PageAccountingError):
        kv.check_invariants()
    kv.ref[4] = 1
    kv.release(0)
    kv.release(1)
    assert kv.used_pages == 0 and not kv.tables["linear"].any()
    kv.check_invariants()
    assert pick_preemption_victim([(0, 9, 0), (1, 9, 3), (2, 12, 5)]) == 1
    sch = SlotScheduler(2, admission="wave")
    for uid in range(3):
        sch.submit(Request(uid, np.ones(2, np.int32)))
    assert [s for s, _ in sch.admit_batch()] == [0, 1]
    sch.release(0)
    assert sch.admit_batch() == []             # the wave is not drained
    pool = {"layers": {"k": torch.zeros(1, 2, 4, 1, 2)}}
    single = {"layers": {"k": torch.ones(1, 1, 3, 1, 2)}}
    cache_insert_slot(pool, single, 1)
    assert pool["layers"]["k"][0, 1, :3].eq(1).all()
    assert not pool["layers"]["k"][0, 0].any()
    sel = cache_select_active({"layers": {"k": torch.ones(1, 2, 4, 1, 2)}},
                              pool, torch.tensor([True, False]))
    assert sel["layers"]["k"][0, 0].eq(1).all()
    assert torch.equal(sel["layers"]["k"][0, 1], pool["layers"]["k"][0, 1])
    assert paging.paged_select_active(pool, None, None) == pool
