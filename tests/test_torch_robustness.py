"""The port's request-lifecycle layer against the JAX reference:
deadlines, cancellation and terminal statuses, failure isolation (poison
prefills, injected device errors), drain with snapshot and restore, the
pool audit, deterministic fault injection, and the errors that must never
be isolated to one request (the kernel layer's, the CUDA runtime's).

Each test of ``tests/test_robustness.py`` is ported against the port's
engine. Across the packages: the chaos benchmark's trace and fault plan
(``repro_torch.testing``, the reference's ``build_trace`` and
``build_chaos_plan``) go through JAX's engine and the port's, which must
agree on the fired log, the statuses, every token and the terminal and
speculative counters; snapshots written by either package restore in
the other; an artifact the port saves loads in JAX.

The smoke model (llama3.2-1b's smoke config, packed at 1 bit with
``min_dim=16``) is drawn from a seed and served in f32 with greedy
decoding, page size 4, the pool audited after every tick.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_common import (f32, jax_tree, one_torch_thread,  # noqa: F401
                           packed_model, torch_params)
from repro import configs as jconfigs
from repro.api import NanoQuantModel as JModel
from repro.serve import Fault as JFault
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import paging as jpaging
from repro.serve import recovery as jrecovery
from repro_torch.api import NanoQuantModel
from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelError
from repro_torch.models import transformer as TT
from repro_torch.serve import (Fault, FaultPlan, InferenceEngine,
                               PageAccountingError, Request, RequestError,
                               ServeConfig, TERMINAL_STATUSES, paging,
                               recovery)
from repro_torch.testing import chaos_plan, chaos_trace, drive_chaos

PS = 4
MODES = {"ref": ops.KernelPolicy(mode="ref"),
         "kernels": ops.KernelPolicy(mode="cuda")}
# the reference's chaos run at its smoke size (benchmarks/serve_bench.py
# run_chaos): 12 requests over 4 slots of max_len 48, a pool of half the
# slots' rectangle, pinned k = 4 at full rank
CHAOS_SEED = 7 + 44
CHAOS_ENGINE = dict(max_batch=4, max_len=48)
CHAOS_SCFG = dict(greedy=True, page_size=PS,
                  kv_pool_pages=4 * (48 // PS) // 2, spec_rank_frac=1.0,
                  spec_k=4, spec_k_min=4, debug=True)
TERMINALS = ("cancelled", "expired", "failed", "device_faults")
SPEC_KEYS = ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_rollback_tokens", "spec_rollback_pages", "decode_steps",
             "tokens_emitted", "preemptions", "steps")


@pytest.fixture(scope="module")
def model():
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    tree = packed_model(cfg, seed=0)
    return cfg, tree, jax_tree(tree), torch_params(tree)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int64)
            for n in lens]


def _engine(model, faults=None, clock=None, max_batch=2, max_len=32,
            policy=None, **scfg_kw):
    cfg, _, _, params = model
    scfg = ServeConfig(**{"greedy": True, "page_size": PS, "debug": True,
                          **scfg_kw})
    return InferenceEngine(params, cfg, scfg, max_batch=max_batch,
                           max_len=max_len, faults=faults, clock=clock,
                           device="cpu", policy=policy)


def _assert_no_leaks(eng):
    eng.check_invariants()
    assert eng.kv.used_pages == eng.kv.cached_page_count
    assert not eng.kv.external
    if eng.prefix is not None:
        eng.prefix.clear()
        assert eng.kv.used_pages == 0


def _baseline(model, prompts, budget, **kw):
    eng = _engine(model, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=budget))
    return {u: r.output for u, r in eng.run().items()}


# ---------------------------------------------------------------------------
# the handle's lifecycle (tests/test_robustness.py, ported)
# ---------------------------------------------------------------------------


def test_cancel_while_queued(model):
    cfg = model[0]
    eng = _engine(model, max_batch=1)
    p1, p2 = _prompts(cfg, [6, 6])
    h1 = eng.submit(Request(0, p1, max_new_tokens=4))
    h2 = eng.submit(Request(1, p2, max_new_tokens=4))
    h2.cancel()
    eng.run()
    assert h1.status == "done" and h1.done and h1.finished
    assert h2.status == "cancelled" and not h2.done and h2.finished
    assert h2.tokens == []                   # never admitted
    with pytest.raises(RequestError, match="request 1 cancelled"):
        h2.result()
    assert h2.error.uid == 1 and h2.error.status == "cancelled"
    assert eng.stats["cancelled"] == 1
    _assert_no_leaks(eng)


def test_cancel_active_keeps_partial_output(model):
    eng = _engine(model, max_batch=1)
    [p] = _prompts(model[0], [6])
    h = eng.submit(Request(0, p, max_new_tokens=16))
    for _ in range(4):
        eng.step()
    assert h.status == "running" and len(h.tokens) >= 2
    h.cancel("user closed the stream")
    eng.run()
    assert h.status == "cancelled"
    assert len(h.tokens) >= 2
    assert np.array_equal(h.request.output, np.asarray(h.tokens))
    with pytest.raises(RequestError, match="user closed the stream"):
        h.result()
    _assert_no_leaks(eng)


def test_handle_reiteration_replays(model):
    eng = _engine(model, max_batch=1)
    [p] = _prompts(model[0], [5])
    h = eng.submit(Request(0, p, max_new_tokens=5))
    first = list(h)
    again = list(h)                          # restarts from token 0
    assert first == again == list(h.result())
    assert len(first) == 5


def test_iterating_failed_handle_raises_at_exhaustion(model):
    eng = _engine(model, max_batch=1)
    p1, p2 = _prompts(model[0], [6, 6])
    h1 = eng.submit(Request(0, p1, max_new_tokens=3))
    h2 = eng.submit(Request(1, p2, max_new_tokens=3))
    h2.cancel()
    eng.run()
    assert list(h1) == list(h1.result())
    with pytest.raises(RequestError, match="cancelled"):
        list(iter(h2))


def test_deadline_expiry_with_injected_clock(model):
    t = [0.0]
    eng = _engine(model, clock=lambda: t[0], max_batch=1)
    [p] = _prompts(model[0], [6])
    h = eng.submit(Request(0, p, max_new_tokens=32, deadline_s=10.0))
    for _ in range(3):
        eng.step()
    assert h.status == "running"
    t[0] = 11.0                              # past the deadline
    eng.step()                               # reaped at the tick boundary
    assert h.status == "expired"
    assert len(h.tokens) >= 2
    with pytest.raises(RequestError, match="deadline 10.0s exceeded"):
        h.result()
    assert eng.stats["expired"] == 1
    assert not eng.in_flight
    _assert_no_leaks(eng)


def test_submit_validation(model):
    """Includes the repair of the duplicate-uid rule: a cancelled
    request's uid is reusable once it is terminal."""
    cfg = model[0]
    eng = _engine(model)
    [p] = _prompts(cfg, [4])
    with pytest.raises(ValueError, match="deadline"):
        eng.submit(Request(0, p, max_new_tokens=2, deadline_s=-1.0))
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(1, np.asarray([0, cfg.vocab_size]),
                           max_new_tokens=2))
    h = eng.submit(Request(2, p, max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate request uid"):
        eng.submit(Request(2, p, max_new_tokens=2))
    h.cancel()
    eng.run()
    assert h.status == "cancelled"
    h2 = eng.submit(Request(2, p, max_new_tokens=2))
    eng.run()
    assert h2.status == "done"


# ---------------------------------------------------------------------------
# failure isolation
# ---------------------------------------------------------------------------


def test_poison_request_is_isolated(model):
    prompts = _prompts(model[0], [6, 7, 8])
    base_out = _baseline(model, prompts, 6)
    plan = FaultPlan([Fault(step=0, kind="poison_prefill", uid=1)])
    eng = _engine(model, faults=plan)
    hs = [eng.submit(Request(uid, p, max_new_tokens=6))
          for uid, p in enumerate(prompts)]
    eng.run()
    assert hs[1].status == "failed"
    assert "non-finite" in hs[1].error.reason
    with pytest.raises(RequestError, match="request 1 failed"):
        hs[1].result()
    assert hs[0].status == hs[2].status == "done"
    for u in (0, 2):                         # neighbours undisturbed
        assert np.array_equal(base_out[u], eng.done[u].output)
    assert eng.stats["failed"] == 1
    _assert_no_leaks(eng)


@pytest.mark.parametrize("kind", ["poison_prefill", "cancel_prefill"])
def test_failed_admission_registers_no_chunk(model, kind):
    """A poisoned prefill, or one cancelled between the prefill and the
    slot's activation, leaves nothing in the prefix index: a later copy
    of its prompt misses and prefills in full."""
    [p] = _prompts(model[0], [3 * PS + 1], seed=3)
    eng = _engine(model, faults=FaultPlan([Fault(step=0, kind=kind,
                                                 uid=0)]))
    h = eng.submit(Request(0, p, max_new_tokens=4))
    eng.run()
    assert h.status == ("failed" if kind == "poison_prefill"
                        else "cancelled")
    assert len(eng.prefix) == 0 and eng.prefix.match(p)[0] == 0
    assert eng.kv.used_pages == 0
    h2 = eng.submit(Request(1, p, max_new_tokens=4))
    eng.run()
    assert h2.status == "done" and eng.stats["prefix_hit_tokens"] == 0
    assert len(eng.prefix) == 3
    _assert_no_leaks(eng)


def test_device_error_recovery(model):
    prompts = _prompts(model[0], [6, 7, 8])
    base_out = _baseline(model, prompts, 8)
    plan = FaultPlan([Fault(step=2, kind="device_error", uid=0)])
    eng = _engine(model, faults=plan)
    hs = [eng.submit(Request(uid, p, max_new_tokens=8))
          for uid, p in enumerate(prompts)]
    eng.run()
    assert eng.stats["device_faults"] == 1
    assert hs[0].status == "failed"
    assert "device error" in hs[0].error.reason
    for u in (1, 2):                         # resumed token-identically
        assert hs[u].status == "done"
        assert np.array_equal(base_out[u], eng.done[u].output)
    _assert_no_leaks(eng)


def test_page_accounting_error_is_engine_fatal(model):
    eng = _engine(model)
    [p] = _prompts(model[0], [6])
    eng.submit(Request(0, p, max_new_tokens=4))
    eng.step()
    owned = next(pages for pages in eng.kv._slot_pages if pages)
    eng.kv._free.append(owned[0])
    with pytest.raises(PageAccountingError):
        eng.check_invariants()


def test_owner_audit(model):
    """The audit checks that the scheduler's owner of a slot is the uid of
    the task in it."""
    eng = _engine(model)
    [p] = _prompts(model[0], [6])
    eng.submit(Request(0, p, max_new_tokens=4))
    eng.step()
    eng.check_invariants()
    slot = eng.slot_of[0]
    eng.scheduler.slots[slot] = 99
    with pytest.raises(PageAccountingError, match="scheduler owner 99"):
        eng.check_invariants()


@pytest.mark.parametrize("err,fatal", [
    (KernelError("fused_lowrank_matmul_grouped: CUDA error 700 at launch"),
     True),
    (KernelError("nvcc failed"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("a fault of this request's own prompt"), False),
], ids=["launch", "build", "cuda-runtime", "cuda-oom", "request"])
def test_device_side_errors_propagate_from_admission(model, monkeypatch,
                                                     err, fatal):
    """An error of the kernel layer or of the CUDA runtime raised during
    an admission propagates out of ``step()`` and fails no handle; any
    other error of the request's prefill fails that handle only."""
    prompts = _prompts(model[0], [6, 9])
    eng = _engine(model)
    hs = [eng.submit(Request(uid, p, max_new_tokens=4))
          for uid, p in enumerate(prompts)]
    real = TT.prefill

    def prefill(params, cfg, tokens, *a, **k):
        if tokens.shape[1] == 16:
            raise err                        # the second prompt's bucket
        return real(params, cfg, tokens, *a, **k)
    monkeypatch.setattr(TT, "prefill", prefill)
    if fatal:
        with pytest.raises(type(err)):
            eng.step()
        assert not any(h.status == "failed" for h in hs)
        assert eng.stats["failed"] == 0
        return
    eng.run()
    assert hs[1].status == "failed" and err.args[0] in hs[1].error.reason
    assert hs[0].status == "done"
    _assert_no_leaks(eng)


def test_kernel_error_propagates_from_decode(model, monkeypatch):
    """A kernel error in the decode step is not taken for the injected
    device error the engine recovers from."""
    eng = _engine(model)
    hs = [eng.submit(Request(uid, p, max_new_tokens=6))
          for uid, p in enumerate(_prompts(model[0], [6, 7]))]
    eng.step()

    def decode_step(*a, **k):
        raise KernelError("paged_decode_attention: CUDA error 719 at launch")
    monkeypatch.setattr(TT, "decode_step", decode_step)
    with pytest.raises(KernelError):
        eng.step()
    assert eng.stats["device_faults"] == 0 and eng.stats["failed"] == 0
    assert all(h.status == "running" for h in hs)


def test_callbacks_all_delivered_then_first_error_raised(model):
    """Every on_token callback of a tick is delivered even when an
    earlier one raises; the first error is raised after the last."""
    eng = _engine(model)
    got = {0: [], 1: []}

    def bad(uid, tok):
        got[uid].append(tok)
        raise KeyError("consumer 0 broke")

    def good(uid, tok):
        got[uid].append(tok)
        if len(got[uid]) == 1:
            raise ValueError("consumer 1 broke")
    p0, p1 = _prompts(model[0], [5, 6])
    h0 = eng.submit(Request(0, p0, max_new_tokens=3), on_token=bad)
    h1 = eng.submit(Request(1, p1, max_new_tokens=3), on_token=good)
    with pytest.raises(KeyError, match="consumer 0"):
        eng.step()
    assert got[0] == h0.tokens and got[1] == h1.tokens
    assert len(got[1]) == 2                  # admission and first decode
    eng.check_invariants()


def test_forget_and_clear_finished(model):
    eng = _engine(model)
    [p] = _prompts(model[0], [5])
    h = eng.submit(Request(0, p, max_new_tokens=4))
    eng.step()
    assert eng.slot_of == {0: 0}
    eng.run()
    assert eng.slot_of == {} and eng.completion_step[0] >= 1
    eng.clear_finished()
    for d in (eng.handles, eng.done, eng.slot_of, eng.admission_step,
              eng.completion_step):
        assert 0 not in d
    assert h.done                            # the caller keeps its handle


# ---------------------------------------------------------------------------
# drain, snapshot and restore
# ---------------------------------------------------------------------------


def test_drain_completes_active_and_closes_admission(model):
    eng = _engine(model, max_batch=2)
    hs = [eng.submit(Request(uid, p, max_new_tokens=4))
          for uid, p in enumerate(_prompts(model[0], [6, 7, 8]))]
    eng.step()                               # admit the first two
    done = eng.drain()
    assert hs[0].status == hs[1].status == "done"
    assert hs[2].status == "pending"
    assert set(done) == {0, 1}
    eng.resume_admission()
    eng.run()
    assert hs[2].status == "done"


def test_drain_snapshot_restore_token_identity(model, tmp_path):
    prompts = _prompts(model[0], [6, 7, 8, 9])
    base_out = _baseline(model, prompts, 8)
    t = [0.0]
    eng = _engine(model, clock=lambda: t[0])
    hs = [eng.submit(Request(uid, p, max_new_tokens=8,
                             deadline_s=100.0 if uid == 0 else None))
          for uid, p in enumerate(prompts)]
    for _ in range(3):
        eng.step()
    t[0] = 40.0
    done_before = eng.drain(timeout=0)       # preempt whatever is live
    snap = recovery.snapshot(eng)
    rec0 = next(it for it in snap["items"] if it["uid"] == 0)
    assert rec0["deadline_left_s"] == pytest.approx(60.0)
    path = os.path.join(str(tmp_path), "snap.json")
    recovery.save_snapshot(eng, path)
    assert recovery.load_snapshot(path)["items"] == snap["items"]
    eng2 = _engine(model, clock=lambda: t[0])
    restored = recovery.restore(eng2, snap)
    assert set(restored) == {u for u, h in enumerate(hs) if not h.finished}
    done_after = eng2.run()
    for u in range(len(prompts)):
        out = (done_before.get(u) or done_after[u]).output
        assert np.array_equal(base_out[u], out), f"request {u} diverged"
    _assert_no_leaks(eng2)


def test_restore_rejects_wrong_geometry(model):
    eng = _engine(model, max_len=32)
    eng.submit(Request(0, _prompts(model[0], [6])[0], max_new_tokens=8))
    eng.drain(timeout=0)
    snap = recovery.snapshot(eng)
    with pytest.raises(ValueError, match="max_len"):
        recovery.restore(_engine(model, max_len=16), snap)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


def test_fault_plan_validates_and_is_deterministic():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(step=0, kind="meteor_strike")
    a = FaultPlan.random(seed=5, uids=range(8), n_steps=20)
    b = FaultPlan.random(seed=5, uids=range(8), n_steps=20)
    assert a.faults == b.faults
    assert a.faults != FaultPlan.random(seed=6, uids=range(8),
                                        n_steps=20).faults
    for seed in (5, 6, 17):                  # one seed, one plan: JAX's
        j = JFaultPlan.random(seed=seed, uids=range(10), n_steps=12,
                              n_faults=16)
        t = FaultPlan.random(seed=seed, uids=range(10), n_steps=12,
                             n_faults=16)
        assert [dataclasses.asdict(f) for f in t.faults] == \
            [dataclasses.asdict(f) for f in j.faults]


def test_fault_replay_is_bit_for_bit(model):
    prompts = _prompts(model[0], [5, 6, 7, 8], seed=3)

    def chaos():
        plan = FaultPlan([Fault(step=0, kind="cancel", uid=2),
                          Fault(step=1, kind="dry_pool", pages=2, hold=2),
                          Fault(step=2, kind="preempt", pages=1)], seed=5)
        eng = _engine(model, faults=plan, kv_pool_pages=10)
        hs = [eng.submit(Request(uid, p, max_new_tokens=6))
              for uid, p in enumerate(prompts)]
        while eng.in_flight or plan.borrowed_pages:
            eng.step()
        return plan.fired, [h.status for h in hs], \
            [list(h.tokens) for h in hs]

    assert chaos() == chaos()


def test_borrowed_pages_in_lockstep_with_jax(model):
    """borrow_pages / return_pages give JAX's page ids; the audit counts
    a borrowed page as referenced, no table maps it, and returning a page
    that was not borrowed is an accounting error."""
    cfg = model[0]
    j = jpaging.PagedKVState(cfg, 2, 16, PS, 7, kinds={"linear"})
    t = paging.PagedKVState(2, 16, PS, 7)
    for kv in (j, t):
        kv.admit(0, 5)
    got, want = t.borrow_pages(3), j.borrow_pages(3)
    assert got == want and t.external == j.external
    assert t.borrow_pages(5) == j.borrow_pages(5)   # what is left: 1 page
    t.check_invariants()
    assert not set(t.tables["linear"].ravel()) & t.external
    assert not t.reserve_rows(0, 9)                  # the pool is dry
    t.return_pages(got)
    j.return_pages(want)
    assert t._free == j._free
    with pytest.raises(PageAccountingError, match="not borrowed"):
        t.return_pages([got[0]])
    t.external.add(got[0])                           # a stray holder
    with pytest.raises(PageAccountingError, match="live mappings"):
        t.check_invariants()


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_randomized_lifecycle_trace(model, seed):
    """Random {submit, cancel, deadline-expire, preempt, drain} trace:
    page accounting and slot alignment hold after every event, every
    handle reaches a terminal status, and zero pages leak at quiesce."""
    cfg = model[0]
    t = [0.0]
    eng = _engine(model, clock=lambda: t[0], max_batch=2, max_len=24,
                  kv_pool_pages=10)
    rng = np.random.default_rng(seed)
    handles, next_uid = {}, 0
    for _ in range(30):
        act = int(rng.integers(0, 6))
        if act <= 1 and next_uid < 8:        # submit (weighted)
            n = int(rng.integers(1, 12))
            prompt = rng.integers(0, cfg.vocab_size, size=(n,))
            deadline = (float(rng.integers(1, 40))
                        if rng.integers(0, 2) else None)
            handles[next_uid] = eng.submit(
                Request(next_uid, prompt,
                        max_new_tokens=int(rng.integers(1, 10)),
                        deadline_s=deadline))
            next_uid += 1
        elif act == 2 and handles:           # cancel a random request
            handles[int(rng.choice(list(handles)))].cancel()
        elif act == 3:                       # advance the deadline clock
            t[0] += float(rng.integers(0, 25))
        elif act == 4 and eng.active.any():  # forced preemption
            eng._preempt(eng._select_victim())
        elif act == 5:                       # drain burst, then reopen
            eng.drain(timeout=0)
            eng.resume_admission()
        eng.step()
        eng.check_invariants()
    eng.run()
    assert all(h.status in TERMINAL_STATUSES for h in handles.values())
    done = sum(h.status == "done" for h in handles.values())
    assert (done + eng.stats["cancelled"] + eng.stats["expired"]
            + eng.stats["failed"] == len(handles))
    _assert_no_leaks(eng)


@pytest.mark.chaos
def test_random_fault_storm_quiesces_clean(model):
    rng = np.random.default_rng(17)
    prompts = _prompts(model[0], list(rng.integers(4, 12, size=10)),
                       seed=17)
    plan = FaultPlan.random(seed=17, uids=range(len(prompts)), n_steps=12,
                            n_faults=16)
    eng = _engine(model, faults=plan, max_batch=3, max_len=24)
    hs = [eng.submit(Request(uid, p, max_new_tokens=8))
          for uid, p in enumerate(prompts)]
    while eng.in_flight or plan.borrowed_pages:
        eng.step()
    assert all(h.finished for h in hs)
    for h in hs:
        if h.status != "done":
            assert isinstance(h.error, RequestError)
    _assert_no_leaks(eng)


@pytest.mark.chaos
def test_preemption_storm_token_identity(model):
    prompts = _prompts(model[0], [6, 7, 8, 9], seed=23)
    base_out = _baseline(model, prompts, 8)
    plan = FaultPlan([Fault(step=s, kind="preempt", pages=1)
                      for s in range(1, 30, 2)])
    eng = _engine(model, faults=plan)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=8))
    done = eng.run()
    assert eng.stats["preemptions"] >= 4
    for u, r in done.items():
        assert np.array_equal(base_out[u], r.output)
    _assert_no_leaks(eng)


def test_spec_cycle_seams(model, monkeypatch):
    """In the speculative cycle the injected device error is raised before
    the cycle enqueues its first kernel (no decode step of that tick
    runs), and the cancel seam sits after the cycle's one host read,
    which stays the only one."""
    cfg = model[0]
    plan = FaultPlan([Fault(step=1, kind="cancel_spec", uid=0),
                      Fault(step=3, kind="device_error", uid=1)])
    eng = _engine(model, faults=plan, max_len=40, spec_rank_frac=1.0,
                  spec_k=4, spec_k_min=4)
    hs = [eng.submit(Request(uid, p, max_new_tokens=20))
          for uid, p in enumerate(_prompts(cfg, [7, 12, 5], seed=4))]
    calls, reads, ticks = [0], [0], []
    real_decode = TT.decode_step

    def decode_step(*a, **k):
        calls[0] += 1
        return real_decode(*a, **k)
    monkeypatch.setattr(TT, "decode_step", decode_step)
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        reads[0] += 1
        return real_cpu(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    real_tick = eng.spec.tick

    def tick(finished):
        calls[0] = reads[0] = 0
        n = len(plan.fired)
        try:
            real_tick(finished)
        finally:
            ticks.append((eng.stats["steps"], calls[0], reads[0],
                          plan.fired[n:]))
    eng.spec.tick = tick
    while eng.in_flight:
        eng.step()
    by_kind = {f[1]: t for t in ticks for f in t[3]}
    assert by_kind["device_error"][1:3] == (0, 0)
    assert by_kind["cancel_spec"][1:3] == (4 + 1, 1)
    assert all(r == 1 for _, c, r, f in ticks if c)
    assert hs[0].status == "cancelled" and hs[1].status == "failed"
    assert hs[2].status == "done"
    _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# the chaos benchmark against JAX's engine
# ---------------------------------------------------------------------------


def _trace(cfg):
    return chaos_trace(np.random.default_rng(CHAOS_SEED), 12, cfg.vocab_size)


def _jax_engine(model, faults=None):
    cfg, _, jparams, _ = model
    return JEngine(jparams, cfg, JServeConfig(**CHAOS_SCFG), faults=faults,
                   **CHAOS_ENGINE)


def _port_engine(model, mode, faults=None):
    return _engine(model, faults=faults, policy=MODES[mode],
                   **CHAOS_ENGINE, **{k: v for k, v in CHAOS_SCFG.items()
                                      if k not in ("greedy", "page_size",
                                                   "debug")})


@pytest.fixture(scope="module")
def jax_chaos(model):
    trace = _trace(model[0])
    plan = JFaultPlan([JFault(**dataclasses.asdict(f))
                       for f in chaos_plan(trace)], seed=CHAOS_SEED)
    eng = _jax_engine(model, plan)
    handles = drive_chaos(eng, trace, JRequest, plan)
    return (plan.fired, {u: h.status for u, h in handles.items()},
            {u: [int(t) for t in h.tokens] for u, h in handles.items()},
            {k: eng.stats[k] for k in TERMINALS + SPEC_KEYS})


@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_matches_jax(model, jax_chaos, mode):
    """The chaos benchmark's contract on the port, and JAX's engine under
    the same plan: every kind fires, every handle is terminal with a
    structured error where not done, survivors keep the undisturbed
    engine's tokens, a replay is bit for bit, no page leaks; the fired
    log, statuses and tokens equal JAX's, and in the unmerged layout
    (JAX's CPU engine's) the terminal and speculative counters too."""
    trace = _trace(model[0])
    base = _port_engine(model, mode)
    base_h = drive_chaos(base, trace, Request)
    assert all(h.status == "done" for h in base_h.values())
    _assert_no_leaks(base)
    runs = []
    for _ in range(2):
        plan = FaultPlan(chaos_plan(trace), seed=CHAOS_SEED)
        eng = _port_engine(model, mode, plan)
        handles = drive_chaos(eng, trace, Request, plan)
        runs.append((plan.fired, {u: h.status for u, h in handles.items()},
                     {u: list(h.tokens) for u, h in handles.items()}))
        st_ = dict(eng.stats)
        for h in handles.values():
            assert h.finished
            if h.status != "done":
                assert isinstance(h.error, RequestError)
                assert (h.error.uid, h.error.status) == (h.uid, h.status)
                assert h.error.reason
        _assert_no_leaks(eng)
    assert runs[0] == runs[1]                # bit for bit
    fired, statuses, tokens = runs[0]
    assert {k for _, k, _ in fired} == {f.kind for f in chaos_plan(trace)}
    assert st_["expired"] == 3 and st_["cancelled"] >= 2
    assert st_["failed"] == 2 and st_["device_faults"] == 1
    survivors = [u for u, s in statuses.items() if s == "done"]
    assert survivors
    for u in survivors:
        assert tokens[u] == list(base_h[u].tokens)
    jfired, jstatuses, jtokens, jstats = jax_chaos
    assert fired == jfired and statuses == jstatuses and tokens == jtokens
    if mode == "ref":
        assert {k: st_[k] for k in TERMINALS + SPEC_KEYS} == jstats


@pytest.mark.parametrize("source", ["port", "jax"])
def test_snapshot_restores_across_packages(model, tmp_path, source):
    """drain → snapshot in one package → restore in the other: both
    complete every request with the undisturbed engine's tokens."""
    trace = _trace(model[0])
    base_h = drive_chaos(_port_engine(model, "ref"), trace, Request)
    if source == "port":
        src, req, rec = _port_engine(model, "ref"), Request, recovery
        dst, dst_rec = _jax_engine(model), jrecovery
    else:
        src, req, rec = _jax_engine(model), JRequest, jrecovery
        dst, dst_rec = _port_engine(model, "ref"), recovery
    for _, uid, prompt, budget in trace:
        src.submit(req(uid, prompt, max_new_tokens=budget))
    for _ in range(3):
        src.step()
    before = dict(src.drain(timeout=0))
    path = os.path.join(str(tmp_path), "snap.json")
    rec.save_snapshot(src, path)
    restored = dst_rec.restore(dst, dst_rec.load_snapshot(path))
    assert any(len(h.tokens) for h in restored.values())
    after = dst.run()
    assert set(before) | set(after) == set(base_h)
    for u, h in base_h.items():
        out = (before.get(u) or after[u]).output
        assert [int(t) for t in out] == list(h.tokens), f"request {u}"
    assert dst.kv.used_pages == dst.kv.cached_page_count


def test_save_loads_in_jax(model, tmp_path):
    """The port's artifact is the JAX package's: JAX's load gives the same
    leaves, bit for bit, and the port's own load round-trips."""
    cfg, tree, _, _ = model
    quant = {"target_bpw": 1.0, "min_dim": 16, "rank_align": 32,
             "pack_k_align": 32}
    m = NanoQuantModel.from_numpy(tree, cfg, device="cpu", quant=quant)
    d = str(tmp_path / "art")
    m.save(d)
    j = JModel.load(d)
    assert j.quantized and j.qcfg.min_dim == 16 and j.cfg == cfg

    def same(want, got):
        for k, v in want.items():
            if isinstance(v, dict):
                same(v, got[k])
            else:
                g = np.asarray(got[k])
                assert g.dtype == v.dtype and np.array_equal(g, v), k
    same(tree, j.params)
    back = NanoQuantModel.load(d, device="cpu")
    assert back.quant == quant

    def same_t(want, got):
        for k, v in want.items():
            if isinstance(v, dict):
                same_t(v, got[k])
            else:
                assert torch.equal(v, got[k]), k
    same_t(m.params, back.params)


# ---------------------------------------------------------------------------
# the rectangular engine (ServeConfig(paged=False)) against JAX's
# ---------------------------------------------------------------------------


RECT_SCFG = dict(greedy=True, paged=False, debug=True)
RECT_KEYS = TERMINALS + ("decode_steps", "tokens_emitted", "admissions",
                         "steps", "preemptions")
DRAIN_LENS = (5, 9)


def _rect_drain(eng, request, prompts):
    """Two requests on `eng` (either package's), one step, then
    ``drain(timeout=0)``: (statuses, tokens, the failed one's reason)."""
    hs = [eng.submit(request(100 + u, p, max_new_tokens=8))
          for u, p in enumerate(prompts)]
    eng.step()
    eng.drain(timeout=0)
    live = [h for h in hs if h.status == "failed"]
    return ([h.status for h in hs], [[int(t) for t in h.tokens] for h in hs],
            live[0].error.reason if live else None)


@pytest.fixture(scope="module")
def jax_rect(model):
    """JAX's rectangular engine through the chaos plan, then a drain with
    no time left; the engine is returned too, its prefill and decode
    compiled, for the snapshot test."""
    cfg, _, jparams, _ = model
    trace = _trace(cfg)
    plan = JFaultPlan([JFault(**dataclasses.asdict(f))
                       for f in chaos_plan(trace)], seed=CHAOS_SEED)
    eng = JEngine(jparams, cfg, JServeConfig(**RECT_SCFG), faults=plan,
                  **CHAOS_ENGINE)
    handles = drive_chaos(eng, trace, JRequest, plan)
    chaos = (plan.fired, {u: h.status for u, h in handles.items()},
             {u: [int(t) for t in h.tokens] for u, h in handles.items()},
             {k: eng.stats[k] for k in RECT_KEYS})
    drain = _rect_drain(eng, JRequest, _prompts(cfg, DRAIN_LENS, seed=5))
    eng.resume_admission()
    return chaos, drain, eng


@pytest.mark.parametrize("mode", list(MODES))
def test_rect_chaos_matches_jax(model, jax_rect, mode):
    """The chaos plan on the rectangular engine against JAX's: the fired
    log (the pool seams, the prefix eviction and the speculative cancel
    stay unfired in both), statuses, tokens and counters equal; the
    device error fails one slot and the others decode on in place (no
    preemption); every non-done handle carries a structured error. Then
    ``drain(timeout=0)`` fails the live slot with JAX's reason, as JAX's
    rectangle cannot checkpoint it either."""
    cfg = model[0]
    trace = _trace(cfg)
    plan = FaultPlan(chaos_plan(trace), seed=CHAOS_SEED)
    eng = _engine(model, faults=plan, policy=MODES[mode], paged=False,
                  **CHAOS_ENGINE)
    assert eng.kv is None
    handles = drive_chaos(eng, trace, Request, plan)
    for h in handles.values():
        assert h.finished
        if h.status != "done":
            assert isinstance(h.error, RequestError) and h.error.reason
    fired = {k for _, k, _ in plan.fired}
    assert not fired & {"dry_pool", "preempt", "evict_prefix", "cancel_spec"}
    assert "device_error" in fired
    assert eng.stats["device_faults"] == 1 and eng.stats["preemptions"] == 0
    (jfired, jstatuses, jtokens, jstats), jdrain, _ = jax_rect
    assert plan.fired == jfired
    assert {u: h.status for u, h in handles.items()} == jstatuses
    assert {u: list(h.tokens) for u, h in handles.items()} == jtokens
    assert {k: eng.stats[k] for k in RECT_KEYS} == jstats
    drain = _rect_drain(eng, Request, _prompts(cfg, DRAIN_LENS, seed=5))
    assert drain == jdrain and drain[0] == ["failed", "failed"]
    assert "cannot checkpoint a live slot" in drain[2]


def test_rect_snapshot_crosses_layouts_and_packages(model, jax_rect):
    """A snapshot of JAX's rectangular engine, taken live 3 steps into the
    chaos trace, restores into the port's paged engine; a snapshot of
    that, 2 steps later, restores into the port's rectangular engine;
    every request then ends with the undisturbed engine's tokens."""
    trace = _trace(model[0])
    base_h = drive_chaos(_port_engine(model, "ref"), trace, Request)
    _, _, src = jax_rect
    for _, uid, prompt, budget in trace:
        src.submit(JRequest(uid, prompt, max_new_tokens=budget))
    for _ in range(3):
        src.step()
    outputs = {u: r.output for u, r in src.done.items()
               if u in base_h and src.handles[u].status == "done"}
    snap = jrecovery.snapshot(src)
    assert any(it["emitted"] for it in snap["items"])
    paged = _engine(model, **CHAOS_ENGINE)
    recovery.restore(paged, snap)
    for _ in range(2):
        paged.step()
    outputs.update({u: r.output for u, r in paged.done.items()})
    snap = recovery.snapshot(paged)
    assert any(it["emitted"] for it in snap["items"])
    rect = _engine(model, paged=False, **CHAOS_ENGINE)
    recovery.restore(rect, snap)
    outputs.update({u: r.output for u, r in rect.run().items()})
    assert set(outputs) == set(base_h)
    for u, h in base_h.items():
        assert [int(t) for t in outputs[u]] == list(h.tokens), f"request {u}"
