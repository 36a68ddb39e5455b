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
from repro_torch.quant.surgery import abstract_quantized_params
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


def _mega_operands(rng, dev, dt, B, pages, ko_pad=0, D=32, PS=16):
    q, kp, vp, bt, pos, _ = _paged(rng, dev, dt, B=B, hq=8, hkv=2, D=D,
                                   PS=PS, pages=pages)
    K, nq, nkv, R = 256, 8 * D, 2 * D, 96
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
    return (x, mqkv, wo, kp, vp, bt, pos, pos), kw


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

