"""The split page walk shared by kernels #2 and #3 (``csrc/paged_walk.cuh``),
as its plain PyTorch model ``paged_attention.split_walk_model``, and the
two launch planners (``_plan_paged``, ``_plan_mega``).

The model cuts each (slot, kv head)'s table into splits, walks each
split's pages with an f32 online softmax, skips pages without a valid row
and merges the splits in split order, as the kernels do. It is held
against ``ref.paged_attention_ref`` and against the JAX package's Pallas
kernels in interpret mode (relative max-abs 1e-5 in f32, 3e-2 in bf16,
the reference harness's ``_tol``), on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_common import assert_close, packed, pair, tol

from repro.kernels.megakernel import decode_step_megakernel_raw as j_mega
from repro.kernels.paged_attention import paged_decode_attention as j_paged
from repro_torch.kernels import megakernel, paged_attention, ref
from repro_torch.kernels.binary_matmul import _MIN_SLICE_WORDS

PS = 8


def _case(seed, B, hq, hkv, D, pages, dt, q_pos=None):
    """Ragged tables (slot b maps 1..pages pages, the rest null), the
    position inside the mapped pages, the last slot all-null; q_pos
    overrides the positions."""
    rng = np.random.default_rng(seed)
    n_pages = B * pages + 1
    kp = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, hq, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, pages), np.int32)
    pos = np.zeros(B, np.int32)
    used = 0
    for b in range(B - 1):
        k = int(rng.integers(1, pages + 1))
        bt[b, :k] = perm[used:used + k]
        used += k
        pos[b] = int(rng.integers(0, k * PS))
    if q_pos is not None:
        pos = np.asarray(q_pos, np.int32)
    return (pair(q, dt), pair(kp, dt), pair(vp, dt), pair(bt), pair(pos),
            pair(pos.copy()))


# (seed, B, Hq, Hkv, D, pages, dtype, window): ragged tables with null
# padding; the later splits of short tables hold only masked pages
CASES = [(1, 4, 8, 2, 16, 6, "f32", 0), (2, 3, 4, 2, 8, 5, "f32", 11),
         (3, 5, 8, 4, 16, 4, "bf16", 0), (4, 4, 6, 3, 8, 7, "bf16", 9)]


@functools.lru_cache(maxsize=None)
def _want(i):
    """The Pallas kernel (interpret mode) and the port's plain version on
    case i, each computed once."""
    seed, B, hq, hkv, D, pages, dt, window = CASES[i]
    c = _case(seed, B, hq, hkv, D, pages, dt)
    scale = 1.0 / math.sqrt(D)
    jx = j_paged(*[x[0] for x in c], window=window, scale=scale,
                 interpret=True)
    pt = ref.paged_attention_ref(*[x[1] for x in c], window=window,
                                 scale=scale)
    return c, np.asarray(jnp.asarray(jx, jnp.float32)), pt


def _normalise(m, l, acc, B, hq, D):
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, 1, hq, D)


@pytest.mark.parametrize("splits", [1, 2, 3, "width"])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_split_walk_matches_reference_and_pallas(i, splits):
    """The model at split counts 1, 2, 3 and one split per table entry
    against the port's oracle and the JAX Pallas kernel."""
    seed, B, hq, hkv, D, pages, dt, window = CASES[i]
    c, want_jax, want_ref = _want(i)
    n = pages if splits == "width" else splits
    q, kp, vp, bt, qp, cp = [x[1] for x in c]
    m, l, acc = paged_attention.split_walk_model(
        q[:, 0], kp, vp, bt, qp, cp, window=window, scale=1.0 / math.sqrt(D),
        splits=n)
    got = _normalise(m, l, acc, B, hq, D)
    assert_close(want_ref, got, tol(dt), f"split walk ({n}) vs oracle")
    assert_close(want_jax, got, tol(dt), f"split walk ({n}) vs pallas")


def test_all_masked_slot_returns_zero():
    """A slot with no valid row (q_pos < 0) walks no page and returns 0,
    as the Pallas kernel does; the others are unaffected."""
    B, hq, hkv, D, pages = 3, 4, 2, 16, 4
    c = _case(7, B, hq, hkv, D, pages, "f32", q_pos=[5, -1, 20])
    q, kp, vp, bt, qp, cp = [x[1] for x in c]
    want = np.asarray(j_paged(*[x[0] for x in c], scale=0.25,
                              interpret=True))
    for splits in (1, 2, pages):
        m, l, acc = paged_attention.split_walk_model(
            q[:, 0], kp, vp, bt, qp, cp, scale=0.25, splits=splits)
        got = _normalise(m, l, acc, B, hq, D)
        assert torch.isinf(m[1]).all() and not bool(l[1].any())
        assert not bool(got[1].any())
        assert_close(want, got, tol("f32"), f"splits={splits}")
    np.testing.assert_array_equal(want[1], 0.0)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("window", [0, 7])
def test_skipping_masked_pages_is_exact(splits, window):
    """Skipping pages without a valid row gives bit for bit what loading
    them and masking their scores with -1e30 gives (the Pallas way), in
    f32: a skipped page would have added p = 0 and alpha = 1."""
    c = _case(8 + window, 4, 8, 2, 16, 5, "f32")
    q, kp, vp, bt, qp, cp = [x[1] for x in c]
    kw = dict(window=window, scale=0.25, splits=splits)
    m1, l1, a1 = paged_attention.split_walk_model(q[:, 0], kp, vp, bt, qp,
                                                  cp, **kw)
    m0, l0, a0 = paged_attention.split_walk_model(
        q[:, 0], kp, vp, bt, qp, cp, skip_masked_pages=False, **kw)
    assert torch.equal(l1, l0) and torch.equal(a1, a0)
    assert torch.equal(_normalise(m1, l1, a1, 4, 8, 16),
                       _normalise(m0, l0, a0, 4, 8, 16))


# ---------------------------------------------------------------------------
# the megakernel's walk: row cache_pos left out, the fresh entry folded in
# ---------------------------------------------------------------------------


def _mega_case(seed, B, hq, hkv, D, K, ranks, pages, dt):
    rng = np.random.default_rng(seed)
    nq, nkv = hq * D, hkv * D
    R, nmax = max(ranks), max(nq, nkv)
    s1 = rng.standard_normal((3, nmax)).astype(np.float32) / np.sqrt(R)
    for i, n in enumerate((nq, nkv, nkv)):
        s1[i, n:] = 0.0
    mqkv = {"qv": rng.integers(0, 2 ** 32, (3, K // 32, R), dtype=np.uint32),
            "qu_t": rng.integers(0, 2 ** 32, (3, R // 32, nmax),
                                 dtype=np.uint32),
            "s1": s1,
            "s2": rng.standard_normal((3, K)).astype(np.float32) / np.sqrt(K),
            "rmask": np.stack([(np.arange(R) < r)
                               for r in ranks]).astype(np.float32)}
    wo = {"qv": packed(rng, nq, 64), "qu_t": packed(rng, 64, K),
          "s1": rng.standard_normal(K).astype(np.float32) / 8.0,
          "s2": rng.standard_normal(nq).astype(np.float32) / np.sqrt(nq)}
    x = rng.standard_normal((B, K)).astype(np.float32)
    c = _case(seed + 1, B, hq, hkv, D, pages, dt)
    return (pair(x, dt), {k: pair(v) for k, v in mqkv.items()},
            {k: pair(v) for k, v in wo.items()}, *c[1:])


def _side(case, s):
    x, mqkv, wo, kp, vp, bt, qp, cp = case
    return (x[s], {k: v[s] for k, v in mqkv.items()},
            {k: v[s] for k, v in wo.items()}, kp[s], vp[s], bt[s], qp[s],
            cp[s])


def _decode_model(x, mqkv, wo, kp, vp, bt, qp, cp, *, head_dim, dims, theta,
                  scale, window, splits):
    """#3's arithmetic with the split walk: projections rounded to x's
    dtype, RoPE, the walk without row cache_pos, the fresh entry folded
    into the merged (m, l, acc), o rounded to x's dtype, then wo."""
    B = x.shape[0]
    nq, nkv = dims
    hq, hkv = nq // head_dim, nkv // head_dim
    G = hq // hkv
    outs = [ref.lowrank_binary_matmul_fused_ref(
        x, mqkv["qv"][g], mqkv["qu_t"][g], mqkv["s1"][g], mqkv["s2"][g],
        mqkv["rmask"][g])[:, :n] for g, n in enumerate((nq, nkv, nkv))]
    q = ref._rope_ref(outs[0].reshape(B, hq, head_dim), qp, theta)
    k_new = ref._rope_ref(outs[1].reshape(B, hkv, head_dim), qp, theta)
    v_new = outs[2].reshape(B, hkv, head_dim)
    m, l, acc = paged_attention.split_walk_model(
        q, kp, vp, bt, qp, cp, window=window, scale=scale, splits=splits,
        exclude_cache_row=True)
    qg = q.float().reshape(B, hkv, G, head_dim)
    s_new = (qg * k_new.float()[:, :, None]).sum(-1) * scale
    m_new = torch.maximum(m, s_new)
    alpha = torch.exp(m - m_new)
    p_new = torch.exp(s_new - m_new)
    l = l * alpha + p_new
    acc = acc * alpha[..., None] + p_new[..., None] * v_new.float()[:, :, None]
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, nq)
    y = ref.lowrank_binary_matmul_fused_ref(o.to(x.dtype), wo["qv"],
                                            wo["qu_t"], wo["s1"], wo["s2"])
    return y, k_new, v_new


@pytest.mark.parametrize("dt,splits,window", [("f32", 1, 0), ("f32", 3, 0),
                                              ("f32", 5, 10),
                                              ("bf16", 2, 0)])
def test_decode_walk_matches_reference_and_pallas(dt, splits, window):
    """The walk without row cache_pos plus the fresh fold, against the
    port's decode-step oracle and the JAX megakernel in interpret mode;
    the all-null last slot's walk is empty (its only valid row is the
    excluded one)."""
    case = _mega_case(30 + splits, 3, 4, 2, 16, 64, (64, 32, 32), 5, dt)
    kw = dict(head_dim=16, dims=(64, 32), theta=10000.0, scale=0.25,
              window=window)
    got = _decode_model(*_side(case, 1), splits=splits, **kw)
    want_ref = ref.decode_step_ref(*_side(case, 1), **kw)
    want_jax = j_mega(*_side(case, 0), bk=32, bn=32, interpret=True, **kw)
    for nm, a, b, c in zip(("y", "k_new", "v_new"), want_ref, want_jax, got):
        assert_close(a, c, tol(dt), f"decode walk vs oracle {nm}")
        assert_close(b, c, tol(dt), f"decode walk vs pallas {nm}")


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------


def _runs(n, per):
    """The contiguous runs [i * per, min(n, (i + 1) * per)) of a cut."""
    return [(i * per, min(n, (i + 1) * per)) for i in range(-(-n // per))]


def _check_cut(n, parts, per):
    runs = _runs(n, per)
    assert len(runs) == parts
    assert all(b > a for a, b in runs), "an empty run"
    covered = [i for a, b in runs for i in range(a, b)]
    assert covered == list(range(n)), "not every index exactly once"


def _check_paged_plan(B, Hkv, pages, sms, cap=paged_attention._MAX_SPLITS):
    plan = paged_attention._plan_paged(B, Hkv, pages, sms, cap)
    _check_cut(pages, plan["splits"], plan["entries_per_split"])
    assert plan["items"] == B * Hkv * plan["splits"]
    assert plan["splits"] <= cap
    if B * Hkv >= sms or pages == 1:
        assert plan["splits"] == 1
    elif plan["items"] < sms:   # short of the card only when no finer
        eps = plan["entries_per_split"]   # cut stays within the cap
        assert eps == 1 or -(-pages // (eps - 1)) > cap
    return plan


# the shapes chip_smoke.py and the engine give the walk: llama3.2-1b
# (Hkv 8, B 8) and qwen1.5-110b (Hkv 8, B 4) at 2, 4 and 32 table entries,
# on the targets #2 (264) and #3 (its co-resident grid) plan for
@pytest.mark.parametrize("B,Hkv,pages", [(8, 8, 4), (8, 8, 32), (4, 8, 2),
                                         (4, 8, 32), (1, 8, 4), (2, 2, 5)])
@pytest.mark.parametrize("sms", [132, 264])
@pytest.mark.parametrize("cap", [paged_attention._CLUSTER,
                                 paged_attention._MAX_SPLITS])
def test_plan_paged_covers_every_entry_once(B, Hkv, pages, sms, cap):
    _check_paged_plan(B, Hkv, pages, sms, cap)


def test_plan_paged_fills_the_card_at_llama_decode():
    """At llama3.2-1b B = 8 the (slot, head) pairs are 64; the plan's
    items reach the 132 SMs that 64 blocks left half idle."""
    assert _check_paged_plan(8, 8, 4, 132)["items"] >= 132
    assert _check_paged_plan(8, 8, 32, 132)["items"] >= 132
    assert _check_paged_plan(8, 8, 1, 132)["splits"] == 1
    assert _check_paged_plan(64, 8, 32, 132)["splits"] == 1


@pytest.mark.parametrize("pairs,want", [(64, 3), (62, 4), (32, 7), (300, 1)])
def test_cluster_cap_keeps_one_wave(monkeypatch, pairs, want):
    """#2 takes the most splits (at most a cluster of 8) whose clusters
    all fit on the card at once: here the occupancy the H100 reported for
    llama3.2-1b's walk, 264 / 132 / 79 / 62 / 47 / 39 / 32 / 30 clusters
    of 1 to 8 blocks."""
    fits = [264, 132, 79, 62, 47, 39, 32, 30]

    class Lib:
        def nq_paged_attention_clusters(self, G, D, PS, pages, splits, code,
                                        out):
            out._obj.value = fits[splits - 1]
            return 0
    monkeypatch.setattr(paged_attention, "_clusters_cache", {})
    assert paged_attention._cluster_cap(Lib(), pairs, 4, 64, 64, 4, 0) == \
        want


@settings(deadline=None, max_examples=60)
@given(B=st.integers(1, 16), Hkv=st.integers(1, 16),
       pages=st.integers(1, 300), sms=st.integers(1, 600),
       cap=st.integers(1, 64))
def test_plan_paged_property(B, Hkv, pages, sms, cap):
    _check_paged_plan(B, Hkv, pages, sms, cap)


def _mega_items(plan, K, r_eff, nq, nkv, Ko, ro_eff, No):
    """Every phase's items as the kernel decodes them, each as the set of
    (what, index) cells it computes."""
    cells = []
    rt, rto = plan["r_tiles"], plan["ro_tiles"]
    s1, so = plan["s1_slices"], plan["o_slices"]
    for item in range(plan["items"]["qkv_stage1"]):
        sl, t, g = item % s1, (item // s1) % rt, item // (s1 * rt)
        w0 = sl * plan["s1_kw"]
        cells += [("qkv1", g, r, w) for r in range(t * 128,
                                                   min(r_eff, t * 128 + 128))
                  for w in range(w0, min(K // 32, w0 + plan["s1_kw"]))]
    nt0, nt1 = -(-nq // 128), -(-nkv // 128)
    for item in range(plan["items"]["qkv_stage2"]):
        g = 0 if item < nt0 else 1 + (item - nt0) // nt1
        n0 = (item if item < nt0 else (item - nt0) % nt1) * 128
        cells += [("qkv2", g, n) for n in range(n0, min((nq, nkv, nkv)[g],
                                                          n0 + 128))]
    for item in range(plan["items"]["wo_stage1"]):
        sl, t = item % so, item // so
        w0 = sl * plan["o_kw"]
        cells += [("wo1", r, w) for r in range(t * 128, min(ro_eff,
                                                            t * 128 + 128))
                  for w in range(w0, min(Ko // 32, w0 + plan["o_kw"]))]
    for item in range(plan["items"]["wo_stage2"]):
        cells += [("wo2", n) for n in range(item * 128,
                                            min(No, item * 128 + 128))]
    return cells


# llama3.2-1b's attention (K 2048, ranks 992 / 384, nq 2048, nkv 512, 8 kv
# heads of 64) at B 1..8, and the smoke config's (K 64, D 16)
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("pages", [4, 32])
@pytest.mark.parametrize("blocks", [132, 264])
@pytest.mark.parametrize("shape", ["llama3.2-1b", "smoke"])
def test_plan_mega_covers_every_item_once(B, pages, blocks, shape):
    K, r_eff, nq, nkv, Ko, ro_eff, No, Hkv, D = {
        "llama3.2-1b": (2048, 992, 2048, 512, 2048, 992, 2048, 8, 64),
        "smoke": (64, 32, 64, 32, 64, 32, 64, 2, 16)}[shape]
    G = nq // nkv
    plan = megakernel._plan_mega(B, K, r_eff, nq, nkv, Ko, ro_eff, No, Hkv,
                                 G, D, pages, blocks, terms=3)
    assert 1 <= plan["grid"] <= blocks
    assert plan["grid"] == min(blocks, max(plan["items"].values()))
    _check_cut(K // 32, plan["s1_slices"], plan["s1_kw"])
    _check_cut(Ko // 32, plan["o_slices"], plan["o_kw"])
    for kw in (plan["s1_kw"], plan["o_kw"]):
        assert kw >= min(_MIN_SLICE_WORDS, K // 32, Ko // 32)
    walk = plan["walk"]
    _check_cut(pages, walk["splits"], walk["entries_per_split"])
    assert walk["items"] == B * Hkv * walk["splits"]
    cells = _mega_items(plan, K, r_eff, nq, nkv, Ko, ro_eff, No)
    assert len(cells) == len(set(cells)), "a cell planned twice"
    want = (3 * r_eff * (K // 32) + nq + 2 * nkv + ro_eff * (Ko // 32) + No)
    assert len(cells) == want, "a cell left out"
    assert plan["tickets"] == 3 * plan["r_tiles"] + B * Hkv + \
        plan["ro_tiles"]
    assert plan["flags"] == 3 * plan["r_tiles"] + \
        plan["items"]["qkv_stage2"] + 8 * Hkv + plan["ro_tiles"]
