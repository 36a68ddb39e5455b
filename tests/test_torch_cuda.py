"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (a CUDA kernel
has no CPU mode). The module imports torch and the port only, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the reference harness's (relative max-abs 1e-5 for f32,
3e-2 for bf16); plain versions run with TF32 off.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import NanoQuantModel
from repro_torch.configs import get_smoke
from repro_torch.kernels import binary_matmul, megakernel, paged_attention, ref
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.quant.surgery import (abstract_quantized_params,
                                       merge_projection_groups)
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.testing import random_packed_params

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(want, got, tol, what):
    a, b = want.float(), got.float()
    assert a.shape == b.shape and torch.isfinite(b).all(), what
    err = float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
    assert err <= tol, f"{what}: rel err {err:.3e} > {tol}"


def _words(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32).view(np.int32))


def _paged(rng, dev, dt, B=6, hq=8, hkv=2, D=64, PS=16, pages=4):
    n_pages = B * pages + 1
    kp = torch.from_numpy(rng.standard_normal((n_pages, PS, hkv, D),
                                              np.float32)).to(dev, dt)
    vp = torch.from_numpy(rng.standard_normal((n_pages, PS, hkv, D),
                                              np.float32)).to(dev, dt)
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, D), np.float32)
                         ).to(dev, dt)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, pages), np.int32)
    pos = np.zeros(B, np.int32)
    used = 0
    for b in range(B - 1):                  # last slot: all-null table
        k = int(rng.integers(1, pages + 1))
        bt[b, :k] = perm[used:used + k]
        used += k
        pos[b] = int(rng.integers(0, k * PS))
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(pos).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m,shared,eff", [(1, True, None), (8, True, 96),
                                          (37, False, None), (512, True, 64)])
def test_grouped_matmul_vs_plain(dev, dt, m, shared, eff):
    rng = np.random.default_rng(m)
    G, K, R, N = 3, 256, 128, 200
    x = torch.from_numpy(rng.standard_normal(
        (1 if shared else G, m, K), np.float32)).to(dev, dt)
    rmask = torch.stack([(torch.arange(R) < r).float()
                         for r in (R, R - 32, R - 64)]).to(dev)
    args = (x, _words(rng, G, K // 32, R).to(dev),
            _words(rng, G, R // 32, N).to(dev),
            torch.from_numpy(rng.standard_normal((G, N), np.float32)).to(dev),
            torch.from_numpy(rng.standard_normal((G, K), np.float32)
                             / K ** 0.5).to(dev), rmask)
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=shared,
                                                     eff_rank=eff)
    torch.cuda.synchronize()
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0 + 1
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(
        *args, x_shared=shared, eff_rank=eff)
    assert got.dtype == dt
    _close(want, got, TOL[dt], "grouped matmul")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("stage,m,k,n,view", [
    ("rank-in", 3, 4064, 200, None), ("rank-in", 8, 8192, 300, 256),
    ("rank-out", 9, 224, 1000, None), ("rank-out", 1, 448, 2500, None)])
def test_packed_matmul_vs_plain(dev, dt, stage, m, k, n, view):
    """Both stages of the two-call chain: stage 1 (long K into a rank,
    several K-split blocks per tile, one view of the leading columns of
    a wider matrix read in place) and stage 2 (a rank into a wide
    output); M, N and K off the tile multiples."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev, dt)
    w = _words(rng, k // 32, n).to(dev)
    if view is not None:
        w = w[:, :view]
        assert not w.is_contiguous()
    n_out = w.shape[1]
    sk = torch.from_numpy(rng.standard_normal(k, np.float32) / k ** 0.5
                          ).to(dev)
    sn = torch.from_numpy(rng.standard_normal(n_out, np.float32)).to(dev)
    n0 = binary_matmul.packed_matmul.launches
    for out_dt in (dt, torch.float32):
        got = binary_matmul.packed_matmul(x, w, sk, sn, out_dtype=out_dt)
        torch.cuda.synchronize()
        want = binary_matmul.packed_matmul_ref(x, w, sk, sn, out_dtype=out_dt)
        assert got.dtype == out_dt
        _close(want, got, TOL[dt], f"packed_matmul {stage} -> {out_dt}")
    got = binary_matmul.packed_matmul(x, w)              # no scales
    _close(binary_matmul.packed_matmul_ref(x, w), got, TOL[dt],
           f"packed_matmul {stage} unscaled")
    assert binary_matmul.packed_matmul.launches == n0 + 3


def _grouped_args(rng, dev, dt, G, m, K, R, N, shared, ranks):
    x = torch.from_numpy(rng.standard_normal(
        (1 if shared else G, m, K), np.float32)).to(dev, dt)
    rmask = torch.stack([(torch.arange(R) < r).float() for r in ranks])
    return (x, _words(rng, G, K // 32, R).to(dev),
            _words(rng, G, R // 32, N).to(dev),
            torch.from_numpy(rng.standard_normal((G, N), np.float32)
                             / R ** 0.5).to(dev),
            torch.from_numpy(rng.standard_normal((G, K), np.float32)
                             / K ** 0.5).to(dev), rmask.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m", [1, 7, 9, 64])
@pytest.mark.parametrize("shared,eff", [(True, None), (False, None),
                                        (True, 96)])
def test_grouped_matmul_edges(dev, dt, m, shared, eff):
    """#1 at edge shapes: row counts on both sides of the 8-row decode
    tile and a full prefill tile; N = 203, a multiple of neither 16 nor
    4 (one-word copies); a merged group whose padded rank columns rmask
    zeroes; an eff_rank view; per-group x. K is long enough for stage 1
    to be split into K slices at decode."""
    rng = np.random.default_rng(100 + m)
    args = _grouped_args(rng, dev, dt, 3, m, 1024, 160, 203, shared,
                         (160, 96, 64))
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=shared,
                                                     eff_rank=eff)
    torch.cuda.synchronize()
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(
        *args, x_shared=shared, eff_rank=eff)
    _close(want, got, TOL[dt], f"grouped matmul M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_grouped_matmul_is_deterministic(dev, dt):
    """The K-slice partial sums are added in slice order, never by
    atomics: two launches give bit-identical results."""
    rng = np.random.default_rng(5)
    args = _grouped_args(rng, dev, dt, 3, 4, 8192, 1024, 512, True,
                         (1024, 864, 864))
    a = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    assert binary_matmul.fused_lowrank_matmul_grouped.plan["slices"] > 1
    b = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_grouped_matmul_raises_when_cooperative_launch_refused(
        dev, monkeypatch):
    """A grid larger than the card holds at once is refused by the
    cooperative launch; the wrapper raises and counts no launch."""
    monkeypatch.setattr(binary_matmul, "_coresident_blocks",
                        lambda *a: 1 << 20)
    rng = np.random.default_rng(6)
    args = _grouped_args(rng, dev, torch.float32, 3, 512, 256, 128, 8192,
                         True, (128, 128, 128))
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0
    monkeypatch.undo()
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    _close(binary_matmul.fused_lowrank_matmul_grouped_ref(*args,
                                                          x_shared=True),
           got, TOL[torch.float32], "grouped matmul after a refused launch")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m", [1, 7, 9, 64])
def test_packed_matmul_edges(dev, dt, m):
    """#4 at row counts on both sides of the decode tile, N = 203 (one-word
    copies of the packed words), every result type it serves: x's, f32,
    and bf16 from f32 x (the merged route's stage 2)."""
    rng = np.random.default_rng(200 + m)
    k, n = 2048, 203
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev, dt)
    w = _words(rng, k // 32, n).to(dev)
    sk = torch.from_numpy(rng.standard_normal(k, np.float32) / k ** 0.5
                          ).to(dev)
    sn = torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev)
    outs = [dt, torch.float32] + ([torch.bfloat16] if dt == torch.float32
                                  else [])
    for out_dt in outs:
        got = binary_matmul.packed_matmul(x, w, sk, sn, out_dtype=out_dt)
        torch.cuda.synchronize()
        want = binary_matmul.packed_matmul_ref(x, w, sk, sn, out_dtype=out_dt)
        assert got.dtype == out_dt
        _close(want, got, TOL[out_dt], f"packed_matmul M={m} -> {out_dt}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("B,pages", [(1, 1), (6, 4), (8, 4), (3, 32),
                                     (8, 32)])
def test_paged_attention_vs_plain(dev, dt, window, B, pages):
    """The split walk at tables of 1, 4 and 32 entries (1 to 4 splits of
    each (slot, head)), ragged, null-padded, the last slot all-null."""
    args = _paged(np.random.default_rng(7 + pages), dev, dt, B=B,
                  pages=pages)
    n0 = paged_attention.paged_decode_attention.launches
    got = paged_attention.paged_decode_attention(*args, window=window,
                                                 scale=0.125)
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention.launches == n0 + 1
    want = ref.paged_attention_ref(*args, window=window, scale=0.125)
    _close(want, got, TOL[dt], "paged attention")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_paged_attention_is_deterministic(dev, dt):
    """The splits of a (slot, head), one thread block cluster, are merged
    in split order, never by float atomics: three launches agree bit for
    bit."""
    args = _paged(np.random.default_rng(17), dev, dt, B=2, hq=32, hkv=8,
                  PS=64, pages=32)
    outs = [paged_attention.paged_decode_attention(*args, scale=0.125)
            for _ in range(3)]
    assert paged_attention.paged_decode_attention.plan["splits"] > 1
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_paged_attention_after_a_smaller_shape(dev, dt):
    """An occupancy query for a smaller shape, between two launches of a
    larger one, must not lower the kernel's shared memory limit under the
    larger launch (a launch then failed with an invalid-value error)."""
    big = _paged(np.random.default_rng(50), dev, dt, B=2, hq=32, hkv=8,
                 PS=64, pages=32)
    small = _paged(np.random.default_rng(51), dev, dt, B=2, hq=4, hkv=2,
                   D=16, PS=8, pages=3)
    paged_attention._clusters_cache.clear()    # the small shape's query runs
    for args in (big, small, big):
        got = paged_attention.paged_decode_attention(*args, scale=0.125)
        torch.cuda.synchronize()
        _close(ref.paged_attention_ref(*args, scale=0.125), got, TOL[dt],
               "paged attention after a smaller shape")


def _ring(rng, dev, dt, B=8, hq=8, hkv=8, D=64, PS=16, pages=4):
    """Whole ring tables (every entry mapped, shuffled), the last slot
    all-null; q_pos past the ring (up to three wraps) and cache_pos =
    q_pos % rows, as the hybrid's decode passes them."""
    n_pages = B * pages + 1
    kp = torch.from_numpy(rng.standard_normal((n_pages, PS, hkv, D),
                                              np.float32)).to(dev, dt)
    vp = torch.from_numpy(rng.standard_normal((n_pages, PS, hkv, D),
                                              np.float32)).to(dev, dt)
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, D), np.float32)
                         ).to(dev, dt)
    bt = rng.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        B, pages)
    bt[-1] = 0
    rows = pages * PS
    pos = rng.integers(rows, 4 * rows, size=B).astype(np.int32)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(pos % rows).to(dev))


def _mega_operands(rng, dev, dt, B, pages, ko_pad=0, D=32, PS=16,
                   hq=8, hkv=2, ring=False):
    q, kp, vp, bt, pos, cpos = (_ring if ring else _paged)(
        rng, dev, dt, B=B, hq=hq, hkv=hkv, D=D, PS=PS, pages=pages)
    K, nq, nkv, R = 256, hq * D, hkv * D, 96
    s1 = rng.standard_normal((3, nq), np.float32) / R ** 0.5
    s1[1:, nkv:] = 0.0
    mqkv = {"qv": _words(rng, 3, K // 32, R), "qu_t": _words(rng, 3, R // 32,
                                                             nq),
            "s1": torch.from_numpy(s1), "rmask": torch.stack(
                [(torch.arange(R) < r).float() for r in (96, 64, 64)]),
            "s2": torch.from_numpy(rng.standard_normal((3, K), np.float32)
                                   / K ** 0.5)}
    ko = nq + ko_pad
    s2o = rng.standard_normal(ko, np.float32) / nq ** 0.5
    s2o[nq:] = 0.0
    wo = {"qv": _words(rng, ko // 32, 64), "qu_t": _words(rng, 2, K),
          "s1": torch.from_numpy(rng.standard_normal(K, np.float32) / 8),
          "s2": torch.from_numpy(s2o)}
    mqkv = {k: v.to(dev) for k, v in mqkv.items()}
    wo = {k: v.to(dev) for k, v in wo.items()}
    x = torch.from_numpy(rng.standard_normal((B, K), np.float32)).to(dev, dt)
    kw = dict(head_dim=D, dims=(nq, nkv), theta=5e5, scale=D ** -0.5)
    return (x, mqkv, wo, kp, vp, bt, pos, cpos), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ko_pad", [0, 32])
@pytest.mark.parametrize("B,pages,window", [(6, 4, 0), (1, 1, 0), (8, 4, 20),
                                            (3, 32, 0), (8, 32, 40)])
def test_megakernel_vs_plain(dev, dt, ko_pad, B, pages, window):
    """#3 at tables of 1, 4 and 32 entries, with and without a window,
    B from 1 to 8, the last slot all-null (its walk is empty once row
    cache_pos is left out), and wo's K padded past nq."""
    args, kw = _mega_operands(np.random.default_rng(8 + ko_pad + pages), dev,
                              dt, B, pages, ko_pad)
    n0 = megakernel.decode_step_megakernel_raw.launches
    got = megakernel.decode_step_megakernel_raw(*args, window=window, **kw)
    torch.cuda.synchronize()
    assert megakernel.decode_step_megakernel_raw.launches == n0 + 1
    want = ref.decode_step_ref(*args, window=window, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        _close(a, b, TOL[dt], f"megakernel {nm}")


# ring-wrapped tables (cache_pos = q_pos % rows, q_pos past the rows):
# (query heads, kv heads) of zamba2's MHA (G = 1) and of a GQA (G = 4),
# D 64, tables of 4, 32 and 64 entries of 16 rows, windows 0, 20 and rows
RING_HEADS = [(8, 8), (8, 2)]
RING_PAGES = [4, 32, 64]


def _window(name, pages, PS=16):
    return {"none": 0, "20": 20, "rows": pages * PS}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hq,hkv", RING_HEADS)
@pytest.mark.parametrize("pages", RING_PAGES)
@pytest.mark.parametrize("window", ["none", "20", "rows"])
def test_paged_attention_at_a_wrapped_ring_vs_plain(dev, dt, hq, hkv, pages,
                                                    window):
    """#2 at ring-wrapped tables (the hybrid's shared-attention decode):
    row r of a slot holds position q_pos - (cache_pos - r) mod rows; every
    slot but the last (all-null) maps a whole ring."""
    args = _ring(np.random.default_rng(60 + pages + hkv), dev, dt, hq=hq,
                 hkv=hkv, pages=pages)
    w = _window(window, pages)
    n0 = paged_attention.paged_decode_attention.launches
    got = paged_attention.paged_decode_attention(*args, window=w,
                                                 scale=0.125)
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention.launches == n0 + 1
    want = ref.paged_attention_ref(*args, window=w, scale=0.125)
    _close(want, got, TOL[dt], f"ring paged attention G={hq // hkv}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hq,hkv", RING_HEADS)
@pytest.mark.parametrize("pages", RING_PAGES)
@pytest.mark.parametrize("window", ["none", "20", "rows"])
def test_megakernel_at_a_wrapped_ring_vs_plain(dev, dt, hq, hkv, pages,
                                               window):
    """#3 at ring-wrapped tables: the walk leaves out row q_pos % rows and
    folds the fresh entry in its place. Held on the slots that map pages
    (the all-null slot maps the null page `pages` times, so the plain
    version's fresh row lands in every copy)."""
    args, kw = _mega_operands(np.random.default_rng(70 + pages + hkv), dev,
                              dt, 8, pages, D=64, hq=hq, hkv=hkv, ring=True)
    w = _window(window, pages)
    n0 = megakernel.decode_step_megakernel_raw.launches
    got = megakernel.decode_step_megakernel_raw(*args, window=w, **kw)
    torch.cuda.synchronize()
    assert megakernel.decode_step_megakernel_raw.launches == n0 + 1
    want = ref.decode_step_ref(*args, window=w, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        _close(a[:-1], b[:-1], TOL[dt], f"ring megakernel {nm}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_megakernel_is_deterministic(dev, dt):
    """K slices and walk splits are summed in order by the last to
    arrive: two launches agree bit for bit, and a batch past 8 slots
    runs 8 at a time."""
    args, kw = _mega_operands(np.random.default_rng(18), dev, dt, 11, 32,
                              D=64, PS=64)
    n0 = megakernel.decode_step_megakernel_raw.launches
    a = megakernel.decode_step_megakernel_raw(*args, **kw)
    b = megakernel.decode_step_megakernel_raw(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel.decode_step_megakernel_raw.launches == n0 + 4
    assert megakernel.decode_step_megakernel_raw.plan["walk"]["splits"] > 1
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    want = ref.decode_step_ref(*args, **kw)
    for nm, u, v in zip(("y", "k_new", "v_new"), want, a):
        _close(u, v, TOL[dt], f"megakernel B=11 {nm}")


@pytest.mark.cuda
def test_megakernel_raises_when_cooperative_launch_refused(dev, monkeypatch):
    """A grid larger than the card holds at once is refused by the
    cooperative launch; the wrapper raises and counts no launch."""
    monkeypatch.setattr(megakernel, "_coresident_blocks", lambda *a: 1 << 20)
    args, kw = _mega_operands(np.random.default_rng(19), dev, torch.float32,
                              8, 64, D=64, PS=64)
    n0 = megakernel.decode_step_megakernel_raw.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        megakernel.decode_step_megakernel_raw(*args, **kw)
    assert megakernel.decode_step_megakernel_raw.launches == n0
    monkeypatch.undo()
    got = megakernel.decode_step_megakernel_raw(*args, **kw)
    want = ref.decode_step_ref(*args, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        _close(a, b, TOL[torch.float32], f"megakernel after refusal {nm}")


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(1)
    q, kp, vp, bt, pos, _ = _paged(rng, dev, torch.float32)
    with pytest.raises(TypeError):                   # pool dtype != q dtype
        paged_attention.paged_decode_attention(q, kp.bfloat16(), vp, bt,
                                               pos, pos)
    with pytest.raises(ValueError):                  # non-contiguous q
        paged_attention.paged_decode_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), kp, vp, bt, pos,
            pos)
    x = torch.zeros((1, 4, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):                   # unsupported dtype
        binary_matmul.fused_lowrank_matmul_grouped(
            x, _words(rng, 1, 2, 32).to(dev), _words(rng, 1, 1, 16).to(dev),
            torch.ones((1, 16), device=dev), torch.ones((1, 64), device=dev))
    with pytest.raises(TypeError):                   # unsupported dtype
        binary_matmul.packed_matmul(x[0], _words(rng, 2, 16).to(dev))
    with pytest.raises(TypeError):                   # words on the host
        binary_matmul.packed_matmul(x[0].float(), _words(rng, 2, 16))


@pytest.mark.cuda
def test_engine_kernels_match_plain_engine(dev):
    """The smoke-size engine on the card through the kernels (megakernel
    on and off, and the two-call chain with ``fused=False``) emits the
    plain-oracle engine's greedy tokens (f32)."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=16), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 19, 9)]

    def serve(policy, mk=None):
        eng = m.engine(ServeConfig(greedy=True, page_size=8, megakernel=mk),
                       max_batch=2, max_len=40, policy=policy)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=7))
        return {u: r.output for u, r in eng.run().items()}

    want = serve(KernelPolicy(mode="ref"))
    counters = (binary_matmul.fused_lowrank_matmul_grouped,
                paged_attention.paged_decode_attention,
                megakernel.decode_step_megakernel_raw,
                binary_matmul.packed_matmul)
    before = [c.launches for c in counters]
    for pol, mk in ((KernelPolicy(mode="cuda"), True),
                    (KernelPolicy(mode="cuda"), False),
                    (KernelPolicy(mode="cuda", fused=False), None)):
        got = serve(pol, mk)
        for u in want:
            np.testing.assert_array_equal(want[u], got[u])
    assert all(c.launches > b for c, b in zip(counters, before))



@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("eff,eff_o", [(64, 32), (32, 64), (96, 64)])
def test_megakernel_eff_rank_vs_plain(dev, dt, eff, eff_o):
    """#3 on a draft view: the merged QKV read at its leading ``eff``
    rank columns and wo at ``eff_o``, in place, against the oracle on the
    same views."""
    args, kw = _mega_operands(np.random.default_rng(30 + eff + eff_o), dev,
                              dt, 8, 4)
    n0 = megakernel.decode_step_megakernel_raw.launches
    got = megakernel.decode_step_megakernel_raw(*args, eff_rank=eff,
                                                eff_rank_o=eff_o, **kw)
    torch.cuda.synchronize()
    assert megakernel.decode_step_megakernel_raw.launches == n0 + 1
    want = ref.decode_step_ref(*args, eff_rank=eff, eff_rank_o=eff_o, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        _close(a, b, TOL[dt], f"megakernel eff_rank {nm}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("S", [3, 5])
def test_multitoken_paged_read_vs_plain(dev, dt, S):
    """The verify's read: S queries through ``ops.paged_attention`` (S
    launches of #2 at shifted positions) over a pool whose rows past each
    slot's frontier hold stale values, the S rows of the call written
    first, so every query but the last sees rows a later query wrote."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(40 + S)
    q, kp, vp, bt, pos, _ = _paged(rng, dev, dt, B=6, PS=16, pages=4)
    q = torch.from_numpy(rng.standard_normal((6, S, 8, 64), np.float32)
                         ).to(dev, dt)
    # room for S rows in every mapped slot: first query at most rows - S
    mapped = (bt != 0).sum(1).cpu().numpy()
    p = np.minimum(pos.cpu().numpy(), np.maximum(mapped * 16 - S, 0))
    p = torch.from_numpy(p.astype(np.int32)).to(dev)
    n0 = paged_attention.paged_decode_attention.launches
    got = ops.paged_attention(q, kp, vp, bt, p, p, scale=0.125,
                              policy=KernelPolicy(mode="cuda"))
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention.launches == n0 + S
    want = ref.paged_attention_ref(q, kp, vp, bt, p, p, scale=0.125)
    _close(want, got, TOL[dt], f"paged attention S={S}")


@pytest.mark.cuda
def test_spec_engine_matches_plain_engine(dev):
    """The speculative engine on the card (draft through #3 at a reduced
    rank, the S = 5 verify through #1 and #2's S launches, rollback)
    emits the plain engine's greedy tokens (f32). Packed at 6 bits per
    weight so that the smoke ranks leave room to truncate."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 6.0,
                                                          min_dim=16), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 19, 9)]

    def serve(frac):
        eng = m.engine(ServeConfig(greedy=True, page_size=8), max_batch=2,
                       max_len=48, spec_rank_frac=frac, spec_k=4,
                       policy=KernelPolicy(mode="cuda"))
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=12))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    want, _ = serve(None)
    for frac in (0.5, 0.9, 1.0):
        before = (megakernel.decode_step_megakernel_raw.launches,
                  paged_attention.paged_decode_attention.launches)
        got, st = serve(frac)
        for u in want:
            np.testing.assert_array_equal(want[u], got[u])
        assert st["spec_cycles"] > 0 and st["spec_draft_tokens"] == \
            st["spec_accepted_tokens"] + st["spec_rollback_tokens"]
        assert megakernel.decode_step_megakernel_raw.launches > before[0]
        assert paged_attention.paged_decode_attention.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_suffix_prefill_matches_full_prefill(dev, dt):
    """A prefix-cache hit on the card: the smoke model prefills a 2-page
    prefix into the pool, then the 5-token suffix straight into the pool
    over it (#1 at M = 5, #2 as 5 launches per layer). Its logits are the
    full prefill's of the same prompt; ``copy_page`` copies exactly."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import paging
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"),
                              dtype=str(dt).removeprefix("torch."))
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=16), 0)
    params = NanoQuantModel.from_numpy(tree, cfg, device=dev, dtype=dt).params
    PS, n, start = 8, 21, 16
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(1, n))).to(dev)
    with ops.kernel_policy(KernelPolicy(mode="cuda")), torch.inference_mode():
        want, _ = T.prefill(params, cfg, prompt,
                            T.init_cache(cfg, 1, 32, dev))
        cache = paging.init_paged_cache(cfg, 6, PS, dev)
        table = torch.tensor([[4, 2, 5, 0]], dtype=torch.int32, device=dev)
        _, single = T.prefill(params, cfg, prompt[:, :start],
                              T.init_cache(cfg, 1, 32, dev))
        paging.paged_insert_slot(cache, single, {"linear": table[0]})
        n0 = paged_attention.paged_decode_attention.launches
        got, cache = T.prefill(params, cfg, prompt[:, start:], cache,
                               start_pos=torch.tensor([start], device=dev),
                               block_tables={"linear": table})
        torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention.launches == \
        n0 + (n - start) * cfg.n_layers
    _close(want, got, TOL[dt], "suffix prefill logits")
    before = {k: v.clone() for k, v in cache["layers"].items()}
    with torch.inference_mode():
        paging.copy_page(cache, 5, 3)
    for k, pool in cache["layers"].items():
        assert torch.equal(pool[:, 3], before[k][:, 5])
        assert torch.equal(pool[:, [0, 1, 2, 4, 5]],
                           before[k][:, [0, 1, 2, 4, 5]])


def _smoke_model(dev, bpw=1.0):
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, bpw,
                                                          min_dim=16), 0)
    return NanoQuantModel.from_numpy(tree, cfg, device=dev)


@pytest.mark.cuda
def test_chaos_on_the_kernel_path(dev):
    """The chaos benchmark at smoke size on the card, through #1, #2 and
    #3 (speculative at full rank, pinned k = 4, prefix cache on, a pool of
    half the slots' rectangle): every kind fires, the survivors emit the
    undisturbed engine's tokens, the replay is bit for bit (fired log,
    statuses, every token) and no page leaks."""
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.testing import chaos_plan, chaos_trace, drive_chaos
    m = _smoke_model(dev)
    trace = chaos_trace(np.random.default_rng(7 + 44), 12,
                        m.cfg.vocab_size)
    scfg = ServeConfig(greedy=True, page_size=4, kv_pool_pages=24,
                       spec_rank_frac=1.0, spec_k=4, spec_k_min=4,
                       debug=True)

    def run(faults=None):
        eng = m.engine(scfg, max_batch=4, max_len=48,
                       policy=KernelPolicy(mode="cuda"), faults=faults)
        hs = drive_chaos(eng, trace, Request, faults)
        eng.check_invariants()
        assert eng.kv.used_pages == eng.kv.cached_page_count
        eng.prefix.clear()
        assert eng.kv.used_pages == 0
        return ({u: h.status for u, h in hs.items()},
                {u: list(h.tokens) for u, h in hs.items()}, eng.stats)

    counters = (binary_matmul.fused_lowrank_matmul_grouped,
                paged_attention.paged_decode_attention,
                megakernel.decode_step_megakernel_raw)
    before = [c.launches for c in counters]
    base_status, base, _ = run()
    assert set(base_status.values()) == {"done"}
    runs = []
    for _ in range(2):
        plan = FaultPlan(chaos_plan(trace), seed=51)
        runs.append((plan.fired,) + run(plan)[:2])
    assert runs[0] == runs[1]
    fired, statuses, tokens = runs[0]
    assert {k for _, k, _ in fired} == {f.kind for f in chaos_plan(trace)}
    survivors = [u for u, s in statuses.items() if s == "done"]
    assert survivors and all(tokens[u] == base[u] for u in survivors)
    assert sorted(statuses.values()).count("failed") == 2
    assert all(c.launches > b for c, b in zip(counters, before))


class _RefusedLaunch:
    """A kernel library whose `name` function reports a CUDA error (700,
    an illegal address) instead of launching."""

    def __init__(self, lib, name):
        self._lib, self._name = lib, name

    def __getattr__(self, attr):
        if attr != self._name:
            return getattr(self._lib, attr)

        class Refused:
            argtypes = restype = None

            def __call__(self, *args):
                return 700
        return Refused()


@pytest.mark.cuda
@pytest.mark.parametrize("when", ["admission", "decode"])
def test_launch_error_propagates_from_the_engine(dev, monkeypatch, when):
    """A launch error of kernel #1 (its C function's error code patched)
    during an admission or a decode step propagates out of ``step()``; no
    request is failed and no injected device error is counted."""
    from repro_torch.kernels import build
    m = _smoke_model(dev)
    eng = m.engine(ServeConfig(greedy=True, page_size=8), max_batch=2,
                   max_len=40, policy=KernelPolicy(mode="cuda"))
    rng = np.random.default_rng(6)
    hs = [eng.submit(Request(u, rng.integers(0, m.cfg.vocab_size, size=n),
                             max_new_tokens=8))
          for u, n in enumerate((5, 9))]
    if when == "decode":
        eng.step()
    real = build.library
    monkeypatch.setattr(build, "library", lambda name, sig=None: (
        _RefusedLaunch(real(name, sig), "nq_fused_lowrank")
        if name == "binary_matmul" else real(name, sig)))
    with pytest.raises(build.KernelError, match="CUDA error 700"):
        eng.step()
    assert not any(h.status == "failed" for h in hs)
    assert eng.stats["failed"] == eng.stats["device_faults"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("linear,m,eff", [("gate", 8, None), ("down", 8, None),
                                          ("gate", 40, None), ("down", 8, 512)])
def test_expert_grid_matmul_vs_plain(dev, dt, linear, m, eff):
    """Kernel #1 at qwen3-moe-235b-a22b's expert grid: G = 128 experts, x
    per group (``x_shared=False``), rank 1088; gate/up K 4096 -> N 1536,
    down K 1536 -> N 4096; M 8 (a decode step's and a 64-token prefill's
    capacity) and 40 (a 256-token prefill's)."""
    rng = np.random.default_rng(len(linear) + m)
    G, R = 128, 1088
    K, N = (4096, 1536) if linear == "gate" else (1536, 4096)
    x = torch.from_numpy(rng.standard_normal((G, m, K), np.float32)
                         ).to(dev, dt)
    args = (x, _words(rng, G, K // 32, R).to(dev),
            _words(rng, G, R // 32, N).to(dev),
            torch.from_numpy(rng.standard_normal((G, N), np.float32)
                             / R ** 0.5).to(dev),
            torch.from_numpy(rng.standard_normal((G, K), np.float32)
                             / K ** 0.5).to(dev))
    grid = binary_matmul.fused_lowrank_matmul_grouped.grid_launches
    n0 = grid.get((G, False), 0)
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=False,
                                                     eff_rank=eff)
    torch.cuda.synchronize()
    assert grid[G, False] == n0 + 1
    assert binary_matmul.fused_lowrank_matmul_grouped.plan["slices"] >= 1
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(
        *args, x_shared=False, eff_rank=eff)
    assert got.dtype == dt
    _close(want, got, TOL[dt], f"expert grid {linear} M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [{}, {"n_shared_experts": 1,
                                          "first_k_dense": 1,
                                          "dense_d_ff": 160}])
def test_moe_engine_kernels_match_plain_engine(dev, variant):
    """The qwen3-moe smoke engine on the card (every expert linear one
    launch of #1 over the 8 experts, attention through #1 and #2: qk_norm
    rules out #3) emits the plain-oracle engine's greedy tokens (f32),
    with and without the prefix cache; the variant adds a shared expert
    and a leading dense block."""
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"),
                              dtype="float32", **variant)
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=16), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(4)
    system = rng.integers(0, cfg.vocab_size, size=16)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in (3, 11, 0)] + [rng.integers(0, cfg.vocab_size,
                                                    size=7)]

    def serve(policy, prefix):
        eng = m.engine(ServeConfig(greedy=True, page_size=8, debug=True),
                       max_batch=2, max_len=48, policy=policy,
                       prefix_cache=prefix)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=6))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    grid = binary_matmul.fused_lowrank_matmul_grouped.grid_launches
    for prefix in (False, True):
        want, _ = serve(KernelPolicy(mode="ref"), prefix)
        n0 = grid.get((cfg.n_experts, False), 0)
        before = (megakernel.decode_step_megakernel_raw.launches,
                  paged_attention.paged_decode_attention.launches)
        got, st = serve(KernelPolicy(mode="cuda"), prefix)
        for u in want:
            np.testing.assert_array_equal(want[u], got[u])
        forwards = st["admissions"] + st["decode_steps"]
        n_moe = cfg.n_layers - cfg.first_k_dense
        assert grid[cfg.n_experts, False] - n0 == 3 * n_moe * forwards
        assert megakernel.decode_step_megakernel_raw.launches == before[0]
        assert paged_attention.paged_decode_attention.launches > before[1]
        assert (st["prefix_hit_tokens"] > 0) == prefix


# kernel #1 at deepseek-v2-lite-16b's shapes, 1.0 bpw: (K, N, R, G, x per
# group) of the attention's w_kr (N and R below one 128-column tile) and
# w_dkv, and of the 64-expert grid's gate/up and down
DEEPSEEK_SHAPES = {"w_kr": (2048, 64, 32, 1, False),
                   "w_dkv": (2048, 512, 384, 1, False),
                   "gate": (2048, 1408, 800, 64, True),
                   "down": (1408, 2048, 800, 64, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("linear,m", [("w_kr", 8), ("w_kr", 1),
                                      ("w_dkv", 8), ("gate", 8),
                                      ("down", 8), ("gate", 32),
                                      ("down", 32)])
def test_deepseek_shapes_matmul_vs_plain(dev, dt, linear, m):
    """Kernel #1 at deepseek-v2-lite-16b's shapes: w_kr (K 2048 -> N 64 at
    rank 32: one partial tile in each stage, stage 2 a single word row),
    w_dkv (-> 512 at rank 384), and the expert grid (G = 64, x per group,
    rank 800: 6.25 rank tiles) at M 8 (a decode step's capacity) and 32
    (a 256-token prefill's)."""
    K, N, R, G, per_group = DEEPSEEK_SHAPES[linear]
    rng = np.random.default_rng(7 * m + len(linear))
    x = torch.from_numpy(rng.standard_normal((G if per_group else 1, m, K),
                                             np.float32)).to(dev, dt)
    args = (x, _words(rng, G, K // 32, R).to(dev),
            _words(rng, G, R // 32, N).to(dev),
            torch.from_numpy(rng.standard_normal((G, N), np.float32)
                             / R ** 0.5).to(dev),
            torch.from_numpy(rng.standard_normal((G, K), np.float32)
                             / K ** 0.5).to(dev))
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    got = binary_matmul.fused_lowrank_matmul_grouped(
        *args, x_shared=not per_group)
    torch.cuda.synchronize()
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0 + 1
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(
        *args, x_shared=not per_group)
    assert got.dtype == dt and got.shape == (G, m, N)
    _close(want, got, TOL[dt], f"deepseek {linear} M={m}")


@pytest.mark.cuda
def test_mla_engine_kernels_match_plain_engine(dev):
    """The deepseek-v2-lite smoke engine on the card (packed with min_dim 8,
    so that w_kr packs too) emits the plain-oracle engine's greedy tokens
    (f32), with and without the prefix cache. Every forward launches #1
    four times per layer (wq, w_dkv, w_kr, wo: MLA's projections are not
    merged), three times per MoE layer at the expert grid, twice per MoE
    layer for the shared expert and twice for the dense block; the
    latent read is plain torch ops, so #2, #3 and #4 never launch."""
    cfg = dataclasses.replace(get_smoke("deepseek-v2-lite-16b"),
                              dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=8), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab_size, size=16)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in (3, 11, 0)] + [rng.integers(0, cfg.vocab_size,
                                                    size=7)]

    def serve(policy, prefix):
        eng = m.engine(ServeConfig(greedy=True, page_size=8, debug=True),
                       max_batch=2, max_len=48, policy=policy,
                       prefix_cache=prefix)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=6))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    fused = binary_matmul.fused_lowrank_matmul_grouped
    n_moe = cfg.n_layers - cfg.first_k_dense
    per_forward = 4 * cfg.n_layers + 5 * n_moe + 2 * cfg.first_k_dense
    for prefix in (False, True):
        want, _ = serve(KernelPolicy(mode="ref"), prefix)
        n0, g0 = fused.launches, fused.grid_launches.get((8, False), 0)
        others = (megakernel.decode_step_megakernel_raw.launches,
                  paged_attention.paged_decode_attention.launches,
                  binary_matmul.packed_matmul.launches)
        got, st = serve(KernelPolicy(mode="cuda"), prefix)
        for u in want:
            np.testing.assert_array_equal(want[u], got[u])
        forwards = st["admissions"] + st["decode_steps"]
        assert fused.launches - n0 == per_forward * forwards
        assert fused.grid_launches[8, False] - g0 == 3 * n_moe * forwards
        assert (megakernel.decode_step_megakernel_raw.launches,
                paged_attention.paged_decode_attention.launches,
                binary_matmul.packed_matmul.launches) == others
        assert (st["prefix_hit_tokens"] > 0) == prefix


# kernel #1 at mamba2-370m's mixer shapes, 1.0 bpw: (K, N, R) of wz / wx,
# wB / wC (rank 96: a partial tile of the rank stage) and out_proj
MAMBA_SHAPES = {"wz": (1024, 2048, 640), "wB": (1024, 128, 96),
                "out_proj": (2048, 1024, 640)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("linear", list(MAMBA_SHAPES))
@pytest.mark.parametrize("m", [8, 256])
def test_mamba_shapes_matmul_vs_plain(dev, dt, linear, m):
    """Kernel #1 at the Mamba2 mixer's packed projections: wz / wx (K 1024
    -> N 2048, rank 640), wB / wC (-> 128 at rank 96, a partial tile of
    the rank stage) and out_proj (K 2048 -> 1024, rank 640), at M 8 (a
    decode step of 8 slots) and 256 (a chunk of prefill)."""
    K, N, R = MAMBA_SHAPES[linear]
    rng = np.random.default_rng(m + len(linear))
    x = torch.from_numpy(rng.standard_normal((1, m, K), np.float32)
                         ).to(dev, dt)
    args = (x, _words(rng, 1, K // 32, R).to(dev),
            _words(rng, 1, R // 32, N).to(dev),
            torch.from_numpy(rng.standard_normal((1, N), np.float32)
                             / R ** 0.5).to(dev),
            torch.from_numpy(rng.standard_normal((1, K), np.float32)
                             / K ** 0.5).to(dev))
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    torch.cuda.synchronize()
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0 + 1
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(*args,
                                                          x_shared=True)
    assert got.dtype == dt and got.shape == (1, m, N)
    _close(want, got, TOL[dt], f"mamba {linear} M={m}")


@pytest.mark.cuda
def test_ssm_decode_step_and_engine_match_plain(dev):
    """The mamba2-370m smoke model on the card (min_dim 16: wz, wx, wB, wC
    and out_proj pack, wdt stays FP): one decode step of three slots from
    a random state, kernel against plain (logits and the active slots'
    state; the inactive slot's state bit for bit), then the state engine's
    greedy tokens against the plain-oracle engine's (f32). Every forward
    launches #1 five times per layer and no other kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_smoke("mamba2-370m"), dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=16), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(3)
    state = {k: torch.from_numpy(rng.standard_normal(
        tuple(v.shape)).astype(np.float32)).to(v.dtype)
        for k, v in TT.init_cache(cfg, 3, 8, "cpu")["layers"].items()}
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 1))
                           ).to(dev)
    active = torch.tensor([True, False, True], device=dev)
    out = {}
    for mode in ("ref", "cuda"):
        cache = {"layers": {k: v.to(dev, copy=True)
                            for k, v in state.items()}}
        with torch.inference_mode(), \
                ops.kernel_policy(KernelPolicy(mode=mode)):
            logits, cache = TT.decode_step(m.params, cfg, tok, cache, None,
                                           active=active)
        out[mode] = (logits, cache["layers"])
    _close(out["ref"][0], out["cuda"][0], 1e-4, "ssm decode logits")
    for k, v in out["cuda"][1].items():
        _close(out["ref"][1][k][:, [0, 2]], v[:, [0, 2]], 1e-4,
               f"ssm decode state {k}")
        assert torch.equal(v[:, 1].cpu(), state[k][:, 1]), k
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 1, 21, 9)]

    def serve(policy):
        eng = m.engine(ServeConfig(greedy=True, debug=True), max_batch=2,
                       max_len=48, policy=policy)
        assert eng.kv is None
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=6))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    fused = binary_matmul.fused_lowrank_matmul_grouped
    want, _ = serve(KernelPolicy(mode="ref"))
    n0 = fused.launches
    others = (megakernel.decode_step_megakernel_raw.launches,
              paged_attention.paged_decode_attention.launches,
              binary_matmul.packed_matmul.launches)
    got, st = serve(KernelPolicy(mode="cuda"))
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
    forwards = st["admissions"] + st["decode_steps"]
    assert fused.launches - n0 == 5 * cfg.n_layers * forwards
    assert (megakernel.decode_step_megakernel_raw.launches,
            paged_attention.paged_decode_attention.launches,
            binary_matmul.packed_matmul.launches) == others


@pytest.mark.cuda
@pytest.mark.parametrize("megakernel_on", [True, False])
def test_hybrid_decode_step_and_engine_match_plain(dev, megakernel_on):
    """The zamba2-1.2b smoke model on the card (min_dim 8: all six mixer
    projections pack, wdt included, and the shared block): one decode step
    of three slots over ring tables (slot 0 before its ring wraps, slot 1
    past it, slot 2 inactive), kernels against plain (logits, the active
    slots' state, the ring pages; the inactive slot's state bit for bit),
    then the engine's greedy tokens at a window of 16 on pages of 8 (the
    rings wrap) against the plain-oracle engine's (f32). A decode forward
    launches #1 six times per layer plus, per application of the shared
    block, twice with #3 or four times with #2 (megakernel off)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_smoke("zamba2-1.2b"), dtype="float32",
                              sliding_window=16)
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=8), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    pol = KernelPolicy(mode="cuda", megakernel=megakernel_on)
    params = {"ref": m.params, "cuda": merge_projection_groups(m.params)}
    rng = np.random.default_rng(4)
    state = {k: torch.from_numpy(rng.standard_normal(
        tuple(v.shape)).astype(np.float32))
        for k, v in TT.state_cache(cfg, 3, "cpu").items()}
    bt = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32)
    pool = {leaf: torch.from_numpy(rng.standard_normal(
        (2, 5, 8, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
        for leaf in ("k", "v")}
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 1))
                           ).to(dev)
    pos = torch.tensor([5, 30, 7], device=dev)
    active = torch.tensor([True, True, False], device=dev)
    out = {}
    for mode, policy in (("ref", KernelPolicy(mode="ref")), ("cuda", pol)):
        cache = {"layers": {k: v.to(dev, copy=True) for k, v in state.items()},
                 "shared_attn": {k: v.to(dev, copy=True)
                                 for k, v in pool.items()}}
        with torch.inference_mode(), ops.kernel_policy(policy):
            logits, cache = TT.decode_step(
                params[mode], cfg, tok, cache, pos,
                block_tables={"ring": bt.to(dev)}, active=active)
        out[mode] = (logits, cache)
    _close(out["ref"][0][:2], out["cuda"][0][:2], 1e-4, "hybrid logits")
    for k, v in out["cuda"][1]["layers"].items():
        _close(out["ref"][1]["layers"][k][:, :2], v[:, :2], 1e-4,
               f"hybrid state {k}")
        assert torch.equal(v[:, 2].cpu(), state[k][:, 2]), k
    for k, v in out["cuda"][1]["shared_attn"].items():
        _close(out["ref"][1]["shared_attn"][k][:, 1:], v[:, 1:], 1e-4,
               f"hybrid ring pool {k}")
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 7, 1, 12)]

    def serve(policy, mk):
        eng = m.engine(ServeConfig(greedy=True, debug=True, page_size=8,
                                   megakernel=mk),
                       max_batch=2, max_len=48, policy=policy)
        assert set(eng.kv.tables) == {"ring"} and eng.kv.ring_pages == 2
        for uid, (p, b) in enumerate(zip(prompts, (26, 20, 30, 9))):
            eng.submit(Request(uid, p, max_new_tokens=b))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    counters = (binary_matmul.fused_lowrank_matmul_grouped,
                paged_attention.paged_decode_attention,
                megakernel.decode_step_megakernel_raw,
                binary_matmul.packed_matmul)
    want, _ = serve(KernelPolicy(mode="ref"), None)
    n0 = [c.launches for c in counters]
    got, st = serve(KernelPolicy(mode="cuda"), megakernel_on)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
    n = [c.launches - b for c, b in zip(counters, n0)]
    apps, mixer = TT.n_shared_apps(cfg), 6 * cfg.n_layers
    pre, dec = st["admissions"], st["decode_steps"]
    assert n[0] == (mixer + 4 * apps) * pre \
        + (mixer + (2 if megakernel_on else 4) * apps) * dec
    assert n[1:] == ([0, apps * dec, 0] if megakernel_on
                     else [apps * dec, 0, 0])


# llama-3.2-vision-90b's self-attention decode at 1.0 bpw: 64 query heads
# over 8 kv heads (G = 8) of D 128, K 8192, merged-QKV ranks 4064 / 864 /
# 864 (padded to 4064), wo rank 4064, pages of 64 rows
VISION = {"hq": 64, "hkv": 8, "D": 128, "K": 8192, "ranks": (4064, 864, 864),
          "ro": 4064, "PS": 64, "theta": 5e5}
# musicgen-medium's decode at 1.0 bpw: 24 query heads over 24 kv heads (G =
# 1, a head count that is no power of two) of D 64, K 1536 (48 words),
# merged-QKV ranks 736, wo rank 736, pages of 64 rows
MUSICGEN = {"hq": 24, "hkv": 24, "D": 64, "K": 1536, "ranks": (736, 736, 736),
            "ro": 736, "PS": 64, "theta": 1e4}


def _mega_operands_at(v, rng, dev, dt, B, pages):
    """#3's operands at a model's shape `v` (:data:`VISION`,
    :data:`MUSICGEN`): a merged QKV group of the three ranks (rmask zeroing
    the padded rank columns, s1 the padded output columns), wo, and a pool
    with ragged tables of B slots, every one mapping pages."""
    _, kp, vp, bt, pos, cpos = _paged(rng, dev, dt, B=B + 1, hq=v["hq"],
                                      hkv=v["hkv"], D=v["D"], PS=v["PS"],
                                      pages=pages)
    bt, pos, cpos = bt[:B].contiguous(), pos[:B], cpos[:B]
    K, R, ro = v["K"], max(v["ranks"]), v["ro"]
    nq, nkv = v["hq"] * v["D"], v["hkv"] * v["D"]
    s1 = rng.standard_normal((3, nq), np.float32)
    for i, (r, n) in enumerate(zip(v["ranks"], (nq, nkv, nkv))):
        s1[i] /= r ** 0.5
        s1[i, n:] = 0.0
    mqkv = {"qv": _words(rng, 3, K // 32, R),
            "qu_t": _words(rng, 3, R // 32, nq),
            "s1": torch.from_numpy(s1),
            "s2": torch.from_numpy(rng.standard_normal((3, K), np.float32)
                                   / K ** 0.5),
            "rmask": torch.stack([(torch.arange(R) < r).float()
                                  for r in v["ranks"]])}
    wo = {"qv": _words(rng, nq // 32, ro), "qu_t": _words(rng, ro // 32, K),
          "s1": torch.from_numpy(rng.standard_normal(K, np.float32)
                                 / ro ** 0.5),
          "s2": torch.from_numpy(rng.standard_normal(nq, np.float32)
                                 / nq ** 0.5)}
    mqkv = {k: t.to(dev) for k, t in mqkv.items()}
    wo = {k: t.to(dev) for k, t in wo.items()}
    x = torch.from_numpy(rng.standard_normal((B, K), np.float32)).to(dev, dt)
    kw = dict(head_dim=v["D"], dims=(nq, nkv), theta=v["theta"],
              scale=v["D"] ** -0.5)
    return (x, mqkv, wo, kp, vp, bt, pos, cpos), kw


def _check_mega_at(v, name, dev, dt, B, pages):
    """One launch of #3 at shape `v` against its plain version and against
    the unfused chain it replaces on the kernel path (#1 merged QKV and
    RoPE, the fresh k / v written into the pool, #2, #1 wo)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    args, kw = _mega_operands_at(v, np.random.default_rng(B * 100 + pages),
                                 dev, dt, B, pages)
    x, mqkv, wo, kp, vp, bt, pos, cpos = args
    n0 = megakernel.decode_step_megakernel_raw.launches
    got = megakernel.decode_step_megakernel_raw(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel.decode_step_megakernel_raw.launches == n0 + 1
    want = ref.decode_step_ref(*args, **kw)
    for nm, a, b in zip(("y", "k_new", "v_new"), want, got):
        _close(a, b, TOL[dt], f"{name} megakernel {nm}")
    nq, nkv = kw["dims"]
    D = kw["head_dim"]
    with ops.kernel_policy(KernelPolicy(mode="cuda")):
        q, k, v = layers.dense_merged(mqkv, x[:, None], (nq, nkv, nkv))
        q = layers.apply_rope(q.reshape(B, 1, nq // D, D), pos[:, None],
                              kw["theta"])
        k = layers.apply_rope(k.reshape(B, 1, nkv // D, D), pos[:, None],
                              kw["theta"])
        layers.paged_cache_write(kp, k, bt, cpos)
        layers.paged_cache_write(vp, v.reshape(B, 1, nkv // D, D), bt, cpos)
        o = ops.paged_attention(q, kp, vp, bt, pos, cpos, scale=kw["scale"])
        y = layers.dense(wo, o.reshape(B, 1, nq))
    _close(y[:, 0], got[0], TOL[dt], f"{name} megakernel y vs chain")
    _close(k.reshape(B, nkv // D, D), got[1], TOL[dt],
           f"{name} megakernel k_new vs chain")
    _close(v.reshape(B, nkv // D, D), got[2], TOL[dt],
           f"{name} megakernel v_new vs chain")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("pages", [2, 32])
def test_megakernel_at_the_vision_shape_vs_plain(dev, dt, B, pages):
    """#3 at llama-3.2-vision-90b's self-attention decode (D 128, G 8, K
    8192, QKV ranks 4064 / 864 / 864, wo rank 4064, pages of 64 rows, 2
    and 32 table entries, B 1-8), against its plain version and its
    unfused chain."""
    _check_mega_at(VISION, "vision", dev, dt, B, pages)


# kernel #1 at the vision model's cross-attention shapes: (K, N, R, M) of
# the image K/V projection (wk / wv over B 4 images of 1024 patches) and of
# the cross block's wq at a decode step of 4 slots
VISION_LINEARS = {"image_wk": (8192, 1024, 864, 4096),
                  "cross_wq": (8192, 8192, 4064, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("linear", list(VISION_LINEARS))
def test_vision_shapes_matmul_vs_plain(dev, dt, linear):
    """Kernel #1 at the image K/V projection (K 8192 -> N 1024 at rank
    864, M = 4 images x 1024 patches = 4096 rows) and at the cross block's
    wq (K 8192 -> N 8192 at rank 4064, M 4): one launch against its plain
    version."""
    K, N, R, m = VISION_LINEARS[linear]
    rng = np.random.default_rng(m + N)
    x = torch.from_numpy(rng.standard_normal((1, m, K), np.float32)
                         ).to(dev, dt)
    args = (x, _words(rng, 1, K // 32, R).to(dev),
            _words(rng, 1, R // 32, N).to(dev),
            torch.from_numpy(rng.standard_normal((1, N), np.float32)
                             / R ** 0.5).to(dev),
            torch.from_numpy(rng.standard_normal((1, K), np.float32)
                             / K ** 0.5).to(dev))
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    torch.cuda.synchronize()
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0 + 1
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(*args,
                                                          x_shared=True)
    assert got.dtype == dt and got.shape == (1, m, N)
    _close(want, got, TOL[dt], f"vision {linear} M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("megakernel_on", [True, False])
def test_vlm_engine_and_generate_match_plain(dev, megakernel_on):
    """The llama-3.2-vision smoke model on the card (min_dim 16: every
    linear packs; gates drawn away from 0): the engine's greedy tokens
    (image K/V zero, as the reference's engine) and ``generate`` with a
    seeded image per prompt, kernels against the plain oracles (f32). A
    decode forward launches #1 twice per cross layer (wq, wo) plus twice
    per self layer with the megakernel off (merged QKV, wo), the FFN's
    merged gate-up and w_down twice per layer, and #3 (or #2) once per
    self layer; a prefill with an image adds wk and wv per cross layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TT
    from repro_torch.serve.engine import generate
    from repro_torch.testing import image_embeds
    cfg = dataclasses.replace(get_smoke("llama-3.2-vision-90b"),
                              dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=16), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 3, 12)]
    counters = (binary_matmul.fused_lowrank_matmul_grouped,
                paged_attention.paged_decode_attention,
                megakernel.decode_step_megakernel_raw,
                binary_matmul.packed_matmul)
    groups = cfg.n_layers // cfg.cross_attn_every
    n_self = cfg.n_layers - groups

    def launches(pre, dec, image=False):
        fused = (2 * n_self + 2 * groups + 2 * cfg.n_layers) * (pre + dec) \
            - (0 if not megakernel_on else 2 * n_self * dec) \
            + (2 * groups * pre if image else 0)
        attn = n_self * dec
        return [fused] + ([0, attn, 0] if megakernel_on else [attn, 0, 0])

    def serve(policy, mk):
        eng = m.engine(ServeConfig(greedy=True, debug=True, page_size=8,
                                   megakernel=mk),
                       max_batch=2, max_len=48, policy=policy)
        assert eng.prefix is None and set(eng.kv.tables) == {"linear"}
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=6))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    want, _ = serve(KernelPolicy(mode="ref"), None)
    n0 = [c.launches for c in counters]
    got, st = serve(KernelPolicy(mode="cuda"), megakernel_on)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u])
    assert [c.launches - b for c, b in zip(counters, n0)] == \
        launches(st["admissions"], st["decode_steps"])
    toks = rng.integers(0, cfg.vocab_size, size=(3, 7))
    img = torch.from_numpy(image_embeds(cfg, 3, 6)).to(dev)
    scfg = ServeConfig(greedy=True, max_new_tokens=5, page_size=8,
                       megakernel=megakernel_on)
    with torch.inference_mode():
        want, wl = generate(m.params, cfg, toks, scfg, image_embeds=img,
                            policy=KernelPolicy(mode="ref"))
        n0 = [c.launches for c in counters]
        got, gl = generate(m.params, cfg, toks, scfg, image_embeds=img,
                           policy=KernelPolicy(mode="cuda"))
    assert torch.equal(want, got)
    _close(wl, gl, 1e-4, "vlm generate logits")
    assert [c.launches - b for c, b in zip(counters, n0)] == \
        launches(1, 5, image=True)
    assert TT.stack_lead(cfg) == {"self_layers": (groups, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("pages", [2, 32])
def test_megakernel_at_the_musicgen_shape_vs_plain(dev, dt, B, pages):
    """#3 at musicgen-medium's decode (D 64, G 1 over 24 heads, K 1536,
    QKV and wo ranks 736, pages of 64 rows, 2 and 32 table entries, B
    1-8), against its plain version and its unfused chain."""
    _check_mega_at(MUSICGEN, "musicgen", dev, dt, B, pages)


# kernel #1 at musicgen-medium's groups: (G, K, N, R) of the merged QKV,
# the merged gate-up and w_down at 1.0 bpw
MUSICGEN_GROUPS = {"qkv": (3, 1536, 1536, 736), "gate_up": (2, 1536, 6144, 1184),
                   "down": (1, 6144, 1536, 1184)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("group", list(MUSICGEN_GROUPS))
@pytest.mark.parametrize("m", [8, 256])
def test_musicgen_groups_matmul_vs_plain(dev, dt, group, m):
    """Kernel #1 at musicgen-medium's merged QKV (G 3, K 1536 -> 3 x 1536,
    rank 736), merged gate-up (G 2, -> 2 x 6144, rank 1184) and w_down
    (6144 -> 1536, rank 1184), x shared by the groups, at a decode step's
    M 8 and a prefill's M 256: one launch against its plain version."""
    G, K, N, R = MUSICGEN_GROUPS[group]
    rng = np.random.default_rng(G * 1000 + m)
    args = _grouped_args(rng, dev, dt, G, m, K, R, N, True, [R] * G)
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    got = binary_matmul.fused_lowrank_matmul_grouped(*args, x_shared=True)
    torch.cuda.synchronize()
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0 + 1
    want = binary_matmul.fused_lowrank_matmul_grouped_ref(*args,
                                                          x_shared=True)
    assert got.dtype == dt and got.shape == (G, m, N)
    _close(want, got, TOL[dt], f"musicgen {group} M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("megakernel_on", [True, False])
def test_audio_engine_and_generate_match_plain(dev, megakernel_on):
    """The musicgen smoke model on the card (min_dim 16: every linear
    packs): the engine's greedy frames and ``generate``'s, kernels against
    the plain oracles (f32). A forward runs #1 for the merged QKV, wo, the
    merged gate-up and w_down of each layer, except that a decode forward
    with the megakernel on runs the attention as one launch of #3 per
    layer (#2 and two launches of #1 with it off)."""
    from repro_torch.serve.engine import generate
    cfg = dataclasses.replace(get_smoke("musicgen-medium"), dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0,
                                                          min_dim=16), 0)
    m = NanoQuantModel.from_numpy(tree, cfg, device=dev)
    rng = np.random.default_rng(5)
    K = cfg.n_codebooks
    prompts = [rng.integers(0, cfg.vocab_size, size=(n, K))
               for n in (5, 9, 3, 12)]
    counters = (binary_matmul.fused_lowrank_matmul_grouped,
                paged_attention.paged_decode_attention,
                megakernel.decode_step_megakernel_raw,
                binary_matmul.packed_matmul)
    n = cfg.n_layers

    def launches(pre, dec):
        fused = 4 * n * pre + (2 if megakernel_on else 4) * n * dec
        return [fused] + ([0, n * dec, 0] if megakernel_on
                          else [n * dec, 0, 0])

    def serve(policy, mk):
        eng = m.engine(ServeConfig(greedy=True, debug=True, page_size=8,
                                   megakernel=mk),
                       max_batch=2, max_len=48, policy=policy)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=6))
        return {u: r.output for u, r in eng.run().items()}, eng.stats

    want, _ = serve(KernelPolicy(mode="ref"), None)
    n0 = [c.launches for c in counters]
    got, st = serve(KernelPolicy(mode="cuda"), megakernel_on)
    for u in want:
        assert got[u].shape == (6, K)
        np.testing.assert_array_equal(want[u], got[u])
    assert [c.launches - b for c, b in zip(counters, n0)] == \
        launches(st["admissions"], st["decode_steps"])
    toks = rng.integers(0, cfg.vocab_size, size=(3, 7, K))
    scfg = ServeConfig(greedy=True, max_new_tokens=5, page_size=8,
                       megakernel=megakernel_on)
    with torch.inference_mode():
        want, wl = generate(m.params, cfg, toks, scfg,
                            policy=KernelPolicy(mode="ref"))
        n0 = [c.launches for c in counters]
        got, gl = generate(m.params, cfg, toks, scfg,
                           policy=KernelPolicy(mode="cuda"))
    assert tuple(got.shape) == (3, 5, K) and torch.equal(want, got)
    _close(wl, gl, 1e-4, "audio generate logits")
    assert [c.launches - b for c, b in zip(counters, n0)] == launches(1, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("K,R,N", [(2048, 1600, 8192),      # llama gate
                                   (8192, 1600, 2048)])     # llama down
def test_packed_linear_autograd_vs_plain(dev, dt, K, R, N):
    """Kernel #1 under its autograd Function (``ops.lowrank_binary_matmul``,
    the KD phase's student linear) against autograd through its plain
    version at llama3.2-1b's gate and down shapes with M = 1024 rows: the
    output and the gradients of x, s1 and s2 within the kernel
    tolerances; the forward launches the kernel once."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(rng.standard_normal((4, 256, K), np.float32)
                         ).to(dev, dt)
    qv = _words(rng, K // 32, R).to(dev)
    qu = _words(rng, R // 32, N).to(dev)
    s1 = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32)
                          / R ** 0.5).to(dev)
    s2 = torch.from_numpy(rng.uniform(0.5, 1.5, K).astype(np.float32)
                          / K ** 0.5).to(dev)
    gy = torch.from_numpy(rng.standard_normal((4, 256, N), np.float32)
                          ).to(dev, dt)
    got_in = [t.clone().requires_grad_() for t in (x, s1, s2)]
    n0 = binary_matmul.fused_lowrank_matmul_grouped.launches
    y = ops.lowrank_binary_matmul(got_in[0], qv, qu, got_in[1], got_in[2])
    got = torch.autograd.grad(y, got_in, gy)
    torch.cuda.synchronize()
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n0 + 1
    want_in = [t.clone().requires_grad_() for t in (x, s1, s2)]
    yp = ref.lowrank_binary_matmul_fused_ref(want_in[0], qv, qu, want_in[1],
                                             want_in[2])
    want = torch.autograd.grad(yp, want_in, gy)
    _close(yp, y, TOL[dt], "packed linear forward")
    for nm, a, b in zip(("x", "s1", "s2"), want, got):
        assert b.dtype == a.dtype
        _close(a, b, TOL[dt], f"d{nm}")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m", [8, 256])
def test_expert_linear_autograd_vs_plain(dev, dt, m):
    """Kernel #1 at deepseek-v2-lite-16b's expert grid (G 64, x per group,
    w_gate's K 2048 -> N 1408 at its 1.0 bpw rank) under the expert
    autograd Function (``ops.lowrank_binary_matmul_expert``, the KD
    phase's expert linears) against autograd through its plain version:
    the output and the gradients of x, s1 and s2 within the kernel
    tolerances; the forward is one launch of the grid."""
    from repro_torch.core.bpw import rank_for_bpw
    from repro_torch.kernels import ops
    G, K, N = 64, 2048, 1408
    R = rank_for_bpw(N, K, 1.0, 32)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((G, m, K), np.float32)
                         ).to(dev, dt)
    qv = _words(rng, G, K // 32, R).to(dev)
    qu = _words(rng, G, R // 32, N).to(dev)
    s1 = torch.from_numpy(rng.uniform(0.5, 1.5, (G, N)).astype(np.float32)
                          / R ** 0.5).to(dev)
    s2 = torch.from_numpy(rng.uniform(0.5, 1.5, (G, K)).astype(np.float32)
                          / K ** 0.5).to(dev)
    gy = torch.from_numpy(rng.standard_normal((G, m, N), np.float32)
                          ).to(dev, dt)
    got_in = [t.clone().requires_grad_() for t in (x, s1, s2)]
    grid = binary_matmul.fused_lowrank_matmul_grouped.grid_launches
    n0 = grid.get((G, False), 0)
    y = ops.lowrank_binary_matmul_expert(got_in[0], qv, qu, got_in[1],
                                         got_in[2])
    got = torch.autograd.grad(y, got_in, gy)
    torch.cuda.synchronize()
    assert grid[G, False] == n0 + 1
    want_in = [t.clone().requires_grad_() for t in (x, s1, s2)]
    yp = binary_matmul.fused_lowrank_matmul_grouped_ref(
        want_in[0], qv, qu, want_in[1], want_in[2], x_shared=False)
    want = torch.autograd.grad(yp, want_in, gy)
    _close(yp, y, TOL[dt], "expert linear forward")
    for nm, a, b in zip(("x", "s1", "s2"), want, got):
        assert b.dtype == a.dtype
        _close(a, b, TOL[dt], f"d{nm}")


@pytest.mark.cuda
def test_stacked_lb_admm_on_the_card_vs_cpu(dev, monkeypatch):
    """LB-ADMM of a stack of experts at deepseek-v2-lite-16b's expert
    shape (d_in 2048, d_out 1408 at the 1.0 bpw rank), one batched solve
    on the card against the same on the CPU from the same draws (made on
    the CPU: the two devices' generators differ), 8 iterations. The
    factors themselves are no gate: the SVID sign projection turns the
    two devices' summation orders into other iterates (measured 11–12 %
    of the proxies' signs differ; on the CPU alone, batched against one
    expert at a time, 8–10 %) of the same quality. Gated: each expert's
    residual trace within 1e-3 relative (measured 3.0e-4), and its
    balanced binary reconstruction's error against W within 1e-2 relative
    of the CPU's (5.9e-4 between the CPU's two orders)."""
    from repro_torch.core import admm, pipeline
    from repro_torch.core.balance import magnitude_balance
    from repro_torch.core.bpw import rank_for_bpw
    E, K, N = 2, 2048, 1408
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((E, K, N)) / K ** 0.5
                          ).astype(np.float32))
    d_in = torch.from_numpy(rng.uniform(0.5, 2, (E, K)).astype(np.float32))
    d_out = torch.from_numpy(rng.uniform(0.5, 2, (E, N)).astype(np.float32))
    draw = admm._rand_range_init
    monkeypatch.setattr(admm, "_rand_range_init", lambda key, t, r: tuple(
        a.to(t.device) for a in draw(key, t.cpu(), r)))
    cfg = pipeline.QuantConfig(admm_iters=8).admm()._replace(
        rank=rank_for_bpw(N, K, 1.0, 32))
    target = d_out[..., None] * w.mT * d_in[:, None]
    res, errs = {}, {}
    for d in ("cpu", "cuda"):
        res[d] = admm.lb_admm(target.to(d), cfg, (0, 1, 2))
        lu, lv, s1, s2 = magnitude_balance(res[d]["p_u"], res[d]["p_v"],
                                           d_out.to(d), d_in.to(d))
        w_hat = (s1[..., None] * torch.sign(lu)) @ (torch.sign(lv).mT
                                                    * s2[:, None])
        errs[d] = (torch.linalg.vector_norm(w.mT.to(d) - w_hat, dim=(1, 2))
                   / torch.linalg.vector_norm(w.mT.to(d), dim=(1, 2))).cpu()
    a, b = (res[d]["residual_trace"].cpu() for d in ("cpu", "cuda"))
    trace_rel = float(((b - a).abs() / a).max())
    err_rel = float(((errs["cuda"] - errs["cpu"]).abs() / errs["cpu"]).max())
    what = (f"traces within {trace_rel:.2e}, reconstruction errors "
            f"{errs['cpu'].tolist()} / {errs['cuda'].tolist()} within "
            f"{err_rel:.2e}")
    assert trace_rel <= 1e-3, what
    assert err_rel <= 1e-2, what
    for k in ("resets", "diverged"):
        assert torch.equal(res["cpu"]["health"][k],
                           res["cuda"]["health"][k].cpu()), k


@pytest.mark.cuda
def test_journaled_drill_on_the_card_is_bit_identical(dev, tmp_path):
    """The crash-safe pipeline on the card at the quantization chaos
    benchmark's size (2 dense layers, d 64, bf16): a journaled run, then a
    run crashed when block 1 starts and resumed from its journal. The
    resume reloads block 0 and gives the uninterrupted run's packed leaves
    and report rows bit for bit (the block steps are deterministic on the
    card: #1 has no float atomics and the rest are plain ops). Preflight
    reads the card's free memory."""
    from repro_torch.checkpoint.journal import _crc_leaves
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import SyntheticCorpus, calib_batches
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    from repro_torch.quant.faults import (InjectedPipelineCrash, QuantFault,
                                          QuantFaultPlan)
    from repro_torch.quant.preflight import preflight
    cfg = ModelConfig(name="chaos-tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=256, loss_chunk=0, remat=False)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    calib = calib_batches(cfg, 8, 32, batch=4,
                          corpus=SyntheticCorpus(cfg.vocab_size))
    qcfg = pipeline.QuantConfig(min_dim=32, admm_iters=6, t_pre=2, t_post=4,
                                t_glob=2)
    info = preflight(params, cfg, calib)
    assert info["device"].startswith("cuda")
    assert 0 < info["available_bytes"] <= torch.cuda.mem_get_info(dev)[1]

    def run(d, **kw):
        return pipeline.nanoquant_quantize(params, cfg, calib, qcfg,
                                           verbose=False, journal_dir=d,
                                           **kw)
    qp0, rep0 = run(str(tmp_path / "a"))
    plan = QuantFaultPlan([QuantFault(1, "crash_block")])
    with pytest.raises(InjectedPipelineCrash):
        run(str(tmp_path / "b"), faults=plan)
    assert plan.fired == [(1, "crash_block")]
    qp1, rep1 = run(str(tmp_path / "b"), resume=True)
    assert qp1["layers"]["attn"]["wq"]["qu_t"].is_cuda
    assert _crc_leaves(qp1) == _crc_leaves(qp0)
    assert rep1["blocks"] == rep0["blocks"]
    assert rep1["kd_losses"] == rep0["kd_losses"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_twocall_linear_autograd_vs_plain(dev, dt):
    """The packed linear's autograd Function on the two-call route (rank
    past #1's 4096: #4 twice, the rank intermediate rounded to x's dtype)
    at the VLM's FFN shape, llama-3.2-vision-90b's w_gate (K 8192 -> N
    28672 at rank 6336) with a KD step's M = 4 x 256 rows, against
    autograd through the two-stage oracle: the output and the gradients
    of x, s1 and s2 within the kernel tolerances; the forward launches #4
    twice and #1 never."""
    from repro_torch.kernels import ops
    K, R, N = 8192, 6336, 28672
    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.standard_normal((4, 256, K), np.float32)
                         ).to(dev, dt)
    qv = _words(rng, K // 32, R).to(dev)
    qu = _words(rng, R // 32, N).to(dev)
    s1 = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32)
                          / R ** 0.5).to(dev)
    s2 = torch.from_numpy(rng.uniform(0.5, 1.5, K).astype(np.float32)
                          / K ** 0.5).to(dev)
    gy = torch.from_numpy(rng.standard_normal((4, 256, N), np.float32)
                          ).to(dev, dt)
    got_in = [t.clone().requires_grad_() for t in (x, s1, s2)]
    n1 = binary_matmul.fused_lowrank_matmul_grouped.launches
    n4 = binary_matmul.packed_matmul.launches
    y = ops.lowrank_binary_matmul(got_in[0], qv, qu, got_in[1], got_in[2])
    got = torch.autograd.grad(y, got_in, gy)
    torch.cuda.synchronize()
    assert binary_matmul.packed_matmul.launches == n4 + 2
    assert binary_matmul.fused_lowrank_matmul_grouped.launches == n1
    want_in = [t.clone().requires_grad_() for t in (x, s1, s2)]
    yp = ref.lowrank_binary_matmul_ref(want_in[0], qv, qu, want_in[1],
                                       want_in[2])
    want = torch.autograd.grad(yp, want_in, gy)
    _close(yp, y, TOL[dt], "two-call linear forward")
    for nm, a, b in zip(("x", "s1", "s2"), want, got):
        assert b.dtype == a.dtype
        _close(a, b, TOL[dt], f"d{nm}")


def _launches_per_forward(tree, lead=None):
    """(#1, #4) launches of one forward of a packed tree with no merged
    groups: per layer of its stack (the VLM's self layers have two leading
    axes), #1 once for a linear up to ``MAX_FUSED_RANK``, #4 twice past
    it."""
    from repro_torch.models.transformer import lead_axes
    if "qu_t" in tree:
        n = int(np.prod(tree["qu_t"].shape[:lead]))
        fused = tree["qv"].shape[-1] <= binary_matmul.MAX_FUSED_RANK
        return (n, 0) if fused else (0, 2 * n)
    out = (0, 0)
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _launches_per_forward(v, lead_axes(k) if lead is None
                                        else lead)
            out = (out[0] + sub[0], out[1] + sub[1])
    return out


@pytest.mark.cuda
def test_vlm_quantized_on_the_card_launches(dev, monkeypatch):
    """The VLM's smoke config quantized on the card in bf16 (gates under
    ``GATE_LAWS``, seeded image embeddings in the calibration) at 2.0 bpw,
    with #1's rank limit lowered to 32 so that the FFN's rank-64 linears
    take the two-call route, as the full-width FFN's rank 6336 does: the
    block errors and KD losses finite, and the launches of #1 and #4 those
    of the template over the blocks' check forwards and the KD steps'
    student forwards (KD's gradients through the Function on both
    routes)."""
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import calib_batches
    from repro_torch.models import transformer as T
    from repro_torch.testing import with_gates
    monkeypatch.setattr(binary_matmul, "MAX_FUSED_RANK", 32)
    cfg = get_smoke("llama-3.2-vision-90b")
    params = with_gates(T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), 5)
    calib = calib_batches(cfg, 8, 32)
    qcfg = pipeline.QuantConfig(target_bpw=2.0, rank_align=16, min_dim=16,
                                admm_iters=6, t_pre=2, t_post=4, t_glob=3)
    n1 = binary_matmul.fused_lowrank_matmul_grouped.launches
    n4 = binary_matmul.packed_matmul.launches
    model = NanoQuantModel.quantize(params, cfg, calib, qcfg, verbose=False,
                                    device=dev)
    torch.cuda.synchronize()
    per = _launches_per_forward(abstract_quantized_params(
        cfg, 2.0, min_dim=16, rank_align=16))
    assert per == _launches_per_forward(model.params) and min(per) > 0
    assert binary_matmul.fused_lowrank_matmul_grouped.launches - n1 == \
        (1 + qcfg.t_glob) * per[0]
    assert binary_matmul.packed_matmul.launches - n4 == \
        (1 + qcfg.t_glob) * per[1]
    rep = model.report
    assert [r["block"] for r in rep["blocks"]] == [
        "self_layers[(0, 0)]", "cross_layers[0]", "self_layers[(1, 0)]",
        "cross_layers[1]"]
    assert all(np.isfinite(r["block_err"]) for r in rep["blocks"])
    assert len(rep["kd_losses"]) == 3 and np.isfinite(rep["kd_losses"]).all()
