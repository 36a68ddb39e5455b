"""The arithmetic of the tensor-core redesign of kernels #1 and #4, on the
CPU, and the fused kernel's launch planner.

Both kernels split an f32 operand into bf16 terms (``split_bf16``: three
for an f32 result, two for a bf16 one; a bf16 operand is one exact term)
and multiply the terms by exact ±1 bf16 factors with f32 sums. Here that
arithmetic runs in plain PyTorch at the real reduction widths of
qwen1.5-110b (K 49152 and 6976 into #4, K 8192 and rank 4064 through #1)
on a few sampled output columns, and is held against the port's oracles
and the JAX package's, with the reference harness's tolerances (relative
max-abs 1e-5 f32, 3e-2 bf16). Operands come from
``np.random.default_rng(seed)``.

``_plan_fused`` is checked at the shapes ``chip_smoke.py`` times: every
stage-1 item (group, M-tile, rank tile, K slice) is planned exactly once,
the workspace size matches its parts, and the grid never exceeds the
co-resident block count it is given.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close, packed, pair, tol
from repro.kernels import ref as jref
from repro_torch.kernels import binary_matmul, ref

COLS = 8                  # sampled output columns


def _split_sum_matmul(v, w_pm1, terms):
    """Σ_terms bf16(term) @ ±1 factor, each product exact, summed in f32:
    what the kernels' mma does with the terms of ``v``."""
    out = None
    for t in binary_matmul.split_bf16(v, terms):
        y = t.float() @ w_pm1
        out = y if out is None else out + y
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_bf16_rebuilds_f32(seed):
    """Three terms rebuild normal f32 values exactly, over a wide range
    of exponents; two terms keep 16 bits; one is the bf16 rounding."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(4096) * 2.0 ** rng.integers(-60, 60, 4096)
         ).astype(np.float32)
    vt = torch.from_numpy(v)
    hi, mid, lo = binary_matmul.split_bf16(vt, 3)
    assert all(t.dtype == torch.bfloat16 for t in (hi, mid, lo))
    assert torch.equal((hi.float() + mid.float()) + lo.float(), vt)
    two = sum(t.float() for t in binary_matmul.split_bf16(vt, 2))
    assert float(((two - vt).abs() / vt.abs()).max()) <= 2.0 ** -16
    (one,) = binary_matmul.split_bf16(vt, 1)
    assert torch.equal(one, vt.to(torch.bfloat16))


# (x dtype, result dtype, terms the kernel takes for that pair)
PACKED_ROUTES = [("f32", torch.float32, 3), ("f32", torch.bfloat16, 2),
                 ("bf16", torch.bfloat16, 1)]


@pytest.mark.parametrize("k", [49152, 6976])
@pytest.mark.parametrize("xdt,out_dtype,terms", PACKED_ROUTES)
def test_split_products_match_packed_oracles(k, xdt, out_dtype, terms):
    """#4's arithmetic at qwen1.5-110b's w_down stage-1 width (49152) and
    its rank width (6976): (x ⊙ s_k) split into terms, times the ±1
    factor, summed in f32, times s_n; against ``ref.packed_matmul_ref``
    and the JAX oracle."""
    rng = np.random.default_rng(k + terms)
    m = 3
    x = pair(rng.standard_normal((m, k)).astype(np.float32), xdt)
    w = pair(packed(rng, k, COLS))
    sk = pair((rng.standard_normal(k) / np.sqrt(k)).astype(np.float32))
    sn = pair(rng.standard_normal(COLS).astype(np.float32))
    xt = x[1]
    if xt.dtype == torch.bfloat16:       # the plain version's bf16 product
        operand = (xt * sk[1].to(torch.bfloat16)).float()
    else:
        operand = xt * sk[1]
    got = (_split_sum_matmul(operand, ref.unpack_signs(w[1]), terms)
           * sn[1]).to(out_dtype)
    name = "f32" if out_dtype == torch.float32 else "bf16"
    want = ref.packed_matmul_ref(xt, w[1], sk[1], sn[1], out_dtype=out_dtype)
    assert_close(want, got, tol(name), f"split vs port oracle, K={k}")
    jwant = jref.packed_matmul_ref(x[0], w[0], sk[0], sn[0])
    assert_close(jwant, got, tol(name), f"split vs JAX oracle, K={k}")


@pytest.mark.parametrize("name,terms", [("f32", 3), ("bf16", 2)])
def test_split_products_match_fused_oracles(name, terms):
    """#1's arithmetic at qwen1.5-110b's merged-QKV widths (K 8192, rank
    4064): x ⊙ s2 split and multiplied by V, the f32 intermediate masked
    by rmask, split again and multiplied by U, times s1; against
    ``ref.lowrank_binary_matmul_fused_ref`` and the JAX oracle."""
    rng = np.random.default_rng(4064 + terms)
    m, k, r = 2, 8192, 4064
    x = pair(rng.standard_normal((m, k)).astype(np.float32), name)
    qv, qu = pair(packed(rng, k, r)), pair(packed(rng, r, COLS))
    s2 = pair((rng.standard_normal(k) / np.sqrt(k)).astype(np.float32))
    s1 = pair((rng.standard_normal(COLS) / np.sqrt(r)).astype(np.float32))
    rmask = pair((np.arange(r) < r - 96).astype(np.float32))
    t = _split_sum_matmul(x[1].float() * s2[1], ref.unpack_signs(qv[1]),
                          terms) * rmask[1]
    got = (_split_sum_matmul(t, ref.unpack_signs(qu[1]), terms)
           * s1[1]).to(x[1].dtype)
    want = ref.lowrank_binary_matmul_fused_ref(x[1], qv[1], qu[1], s1[1],
                                               s2[1], rmask[1])
    assert_close(want, got, tol(name), "split vs port fused oracle")
    jwant = jref.lowrank_binary_matmul_fused_ref(x[0], qv[0], qu[0], s1[0],
                                                 s2[0], rmask[0])
    assert jwant.dtype == (jnp.float32 if name == "f32" else jnp.bfloat16)
    assert_close(jwant, got, tol(name), "split vs JAX fused oracle")


# the fused kernel's shapes in chip_smoke.py: (G, K, R, N) per group at
# each timed M, and rank views (eff_rank) of them
LLAMA = {"qkv": (3, 2048, 992, 2048), "wo": (1, 2048, 992, 2048),
         "gate_up": (2, 2048, 1600, 8192), "down": (1, 8192, 1600, 2048)}
QWEN = {"qkv": (3, 8192, 4064, 8192), "wo": (1, 8192, 4064, 8192)}
SHAPES = ([(g, m, None) for g in LLAMA.values() for m in (1, 8, 512)]
          + [(g, m, None) for g in QWEN.values() for m in (1, 8, 64)]
          + [(LLAMA["gate_up"], 8, 512), (QWEN["qkv"], 1, 2048),
             (QWEN["wo"], 64, 1024)])
BLOCKS = [1, 132, 264, 396, 528]          # co-resident counts to plan for


def _stage1_items(plan):
    """The (group, M-tile, rank tile, K slice) of each stage-1 item, in
    the kernel's order (slice fastest)."""
    S, rt, mt = plan["slices"], plan["r_tiles"], plan["m_tiles"]
    return [(i // (S * rt * mt), (i // (S * rt)) % mt, (i // S) % rt, i % S)
            for i in range(plan["stage1_items"])]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("shape,m,eff", SHAPES)
def test_plan_fused_covers_stage1_once(shape, m, eff, blocks):
    """Every (group, M-tile, rank tile) gets K slices that cover its
    words exactly once, none empty, each planned once."""
    G, K, R, N = shape
    r_eff = R if eff is None else eff
    plan = binary_matmul._plan_fused(G, m, K, r_eff, N, blocks)
    items = _stage1_items(plan)
    assert len(set(items)) == len(items)
    assert plan["m_tiles"] * plan["bm"] >= m > (plan["m_tiles"] - 1) * plan["bm"]
    assert plan["r_tiles"] * 128 >= r_eff > (plan["r_tiles"] - 1) * 128
    kw, per = K // 32, plan["kw_per_slice"]
    for g in range(G):
        for mt in range(plan["m_tiles"]):
            for rt in range(plan["r_tiles"]):
                words = []
                for sl in range(plan["slices"]):
                    assert (g, mt, rt, sl) in items
                    rng = range(sl * per, min(kw, (sl + 1) * per))
                    assert len(rng) > 0
                    words += rng
                assert words == list(range(kw))
    assert plan["stage1_items"] == G * plan["m_tiles"] * plan["r_tiles"] \
        * plan["slices"]
    assert plan["stage2_items"] == G * plan["m_tiles"] * plan["n_tiles"]


@pytest.mark.parametrize("terms", [3, 2])
@pytest.mark.parametrize("shape,m,eff", SHAPES)
def test_plan_fused_workspace_and_grid(shape, m, eff, terms):
    """The workspace holds x ⊙ s2 and the intermediate as bf16 terms plus
    G × slices × M × r_eff f32 partial sums; the grid never exceeds the
    co-resident count and is never empty."""
    G, K, R, N = shape
    r_eff = R if eff is None else eff
    for blocks in BLOCKS:
        plan = binary_matmul._plan_fused(G, m, K, r_eff, N, blocks,
                                         terms=terms)
        partial = 4 * G * plan["slices"] * m * r_eff
        assert plan["partial_bytes"] == partial
        assert plan["workspace_bytes"] == (2 * G * terms * m * K
                                           + 2 * G * terms * m * r_eff
                                           + partial)
        assert 1 <= plan["grid"] <= blocks
        assert plan["grid"] <= max(plan["stage1_items"], plan["stage2_items"])
        assert plan["terms"] == terms and plan["blocks"] == blocks


def test_plan_fused_fills_the_card_at_decode():
    """At decode the K slices bring stage 1 up to the co-resident blocks
    (qwen1.5-110b merged QKV at M = 1: 96 (group, rank tile) pairs, 4
    slices of 64 words for 396 blocks); at prefill the M-tiles do and K
    is not split."""
    plan = binary_matmul._plan_fused(3, 1, 8192, 4064, 8192, 396)
    assert (plan["slices"], plan["kw_per_slice"]) == (4, 64)
    assert plan["stage1_items"] == 384 == plan["grid"]
    plan = binary_matmul._plan_fused(3, 512, 2048, 992, 2048, 264)
    assert plan["slices"] == 1 and plan["bm"] == 64 and plan["m_tiles"] == 8


@pytest.mark.parametrize("m,k,n", [(1, 49152, 6976), (8, 6976, 49152),
                                   (64, 8192, 6976), (8, 6976, 8192),
                                   (9, 224, 1000), (512, 2048, 992),
                                   (1, 8192, 6976), (64, 6976, 49152)])
def test_plan_packed_splits_cover_k(m, k, n):
    """packed_matmul's K splits cover the words once, none empty, at most
    one cluster of 8, and split K only while the output tiles fall short
    of about four blocks per SM; the row tile covers M in tiles of 8, 16,
    32 or 64."""
    plan = binary_matmul._plan_packed(m, k, n)
    kw, ks, per = k // 32, plan["ks"], plan["kw_per_split"]
    assert 1 <= ks <= 8 and per * (ks - 1) < kw <= per * ks
    tiles = plan["m_tiles"] * plan["n_tiles"]
    assert ks == 1 or tiles * (ks - 1) < 4 * 132
    assert plan["bm"] in (8, 16, 32, 64)
    assert plan["bm"] == 8 if m <= 8 else plan["bm"] >= min(m, 64)
    assert plan["m_tiles"] == -(-m // plan["bm"])
    assert plan["n_tiles"] == -(-n // 128)
