"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the same
numpy inputs go to the JAX reference (``repro``) and to the PyTorch port
(``repro_torch``), and the outputs are compared with the tolerances of
``tests/test_kernel_diff.py::_tol``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.convert import params_from_numpy, tensor_from_numpy

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(name: str) -> float:
    """Relative max-abs tolerance of the reference's differential harness:
    f32 results differ only by summation order, bf16 by rounding."""
    return 1e-5 if name == "f32" else 3e-2


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(a)))) if a.size else 1.0
    return float(np.max(np.abs(a - b))) / scale if a.size else 0.0


def assert_close(ref, got, tolerance, what=""):
    err = rel_err(to_np(ref), to_np(got))
    assert err <= tolerance, f"{what}: rel err {err:.3e} > {tolerance}"


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def pair(arr: np.ndarray, dtype_name: str = None):
    """One numpy array as (jax array, CPU tensor), floats cast to the
    named dtype in both frameworks (both round to nearest even)."""
    if arr.dtype == np.uint32 or np.issubdtype(arr.dtype, np.integer) \
            or dtype_name is None:
        return jnp.asarray(arr), tensor_from_numpy(arr)
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(arr, jnp.float32).astype(jd), \
        torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(td)


def packed(rng, k: int, n: int) -> np.ndarray:
    """Random packed ±1 words of a (k, n) matrix."""
    return rng.integers(0, 2 ** 32, size=(k // 32, n), dtype=np.uint32)


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def packed_model(cfg, seed: int, min_dim: int = 16, bpw: float = 1.0):
    """A packed dense model of `cfg`'s shape at `bpw` bits per weight from
    a seed, as the numpy tree both packages take (f32 FP leaves, uint32
    words)."""
    from repro_torch.quant.surgery import abstract_quantized_params
    from repro_torch.testing import random_packed_params
    return random_packed_params(
        abstract_quantized_params(cfg, bpw, min_dim=min_dim), seed)


def torch_params(tree):
    return params_from_numpy(tree, "cpu")


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# ---------------------------------------------------------------------------
# whole-model parity: forward, prefill and paged decode against JAX
# ---------------------------------------------------------------------------


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def check_forward(cfg, jparams, tparams, policy, tolerance, what):
    """The full-sequence forward of both packages on one token batch."""
    import jax
    from repro.models import transformer as JT
    from repro_torch.kernels.ops import kernel_policy
    from repro_torch.models import transformer as TT
    toks = tokens(cfg, (2, 11), 1)
    want = jax.jit(lambda p, t: JT.forward(p, cfg, t))(jparams, toks)
    with kernel_policy(policy):
        got = TT.forward(tparams, cfg, torch.from_numpy(toks).long())
    assert_close(want, got, tolerance, f"forward ({what})")


def check_prefill(cfg, jparams, tparams, policy, tolerance, what):
    """A bucket-padded prefill into a rectangular cache: the logits at the
    last real token and every stack's cache rows."""
    import jax
    from repro.models import transformer as JT
    from repro_torch.kernels.ops import kernel_policy
    from repro_torch.models import transformer as TT
    toks = tokens(cfg, (1, 16), 2)
    n = 13                                  # right-padded to a bucket
    want, jcache = jax.jit(lambda p, t: JT.prefill(
        p, cfg, t, JT.init_cache(cfg, 1, 24), last_idx=n - 1))(jparams, toks)
    with kernel_policy(policy):
        got, tcache = TT.prefill(tparams, cfg, torch.from_numpy(toks).long(),
                                 TT.init_cache(cfg, 1, 24, "cpu"),
                                 last_idx=n - 1)
    assert_close(want, got, tolerance, f"prefill logits ({what})")
    assert sorted(jcache) == sorted(tcache)
    for stack in jcache:
        assert list(tcache[stack]) == list(TT.cache_leaves(cfg))
        assert sorted(jcache[stack]) == sorted(tcache[stack])
        for leaf in tcache[stack]:
            assert_close(jcache[stack][leaf], tcache[stack][leaf], tolerance,
                         f"prefill cache {stack}/{leaf} ({what})")


def check_paged_decode(cfg, jparams, tparams, policy, tolerance, what):
    """One batched decode step over a paged pool (one per block stack, a
    pool per cache leaf: k / v, or MLA's c_kv / k_rope) with ragged tables
    and an inactive (all-null) slot."""
    import jax
    from repro.models import transformer as JT
    from repro_torch.kernels.ops import kernel_policy
    from repro_torch.models import transformer as TT
    rng = np.random.default_rng(3)
    PS = 4
    pools = {name: {leaf: rng.standard_normal((n, 10, PS) + row
                                              ).astype(np.float32)
                    for leaf, row in TT.cache_leaves(cfg).items()}
             for name, n in TT.stack_depths(cfg).items()}
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 5, 2], np.int32)
    tok = tokens(cfg, (3, 1), 4)

    def cache(lib):
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        return {name: {leaf: conv(pool.copy()) for leaf, pool in ps.items()}
                for name, ps in pools.items()}

    want, jc = jax.jit(lambda p, t, c, q, b: JT.decode_step(
        p, cfg, t, c, q, block_tables={"linear": b}))(
            jparams, tok, cache("jax"), pos, bt)
    with kernel_policy(policy):
        got, tc = TT.decode_step(
            tparams, cfg, torch.from_numpy(tok).long(), cache("torch"),
            torch.from_numpy(pos).long(),
            block_tables={"linear": torch.from_numpy(bt)})
    assert_close(want, got, tolerance, f"decode logits ({what})")
    for name in pools:
        for leaf in pools[name]:
            # the inactive slot's write lands on the null page 0, whose
            # content is trash by design: compare the real pages only
            assert_close(jc[name][leaf][:, 1:], tc[name][leaf][:, 1:],
                         tolerance, f"decode pool {name}/{leaf} ({what})")


# ---------------------------------------------------------------------------
# engines, artifacts and templates of both packages
# ---------------------------------------------------------------------------


def cast_jax(tree, dtype):
    """JAX's model cast: FP leaves to `dtype`, packed leaves, the router
    and the Mamba2 mixer's A_log / D / dt_bias kept as stored (f32, as
    JAX's init keeps them)."""
    from repro_torch.convert import KEEP_F32

    def walk(node, keep):
        if isinstance(node, dict):
            return {k: walk(v, keep or "qu_t" in node or k in KEEP_F32)
                    for k, v in node.items()}
        return node if keep or node.dtype != jnp.float32 \
            else node.astype(dtype)
    return walk(tree, False)


def draw_prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in lens]


def shared_prompts(cfg, ps: int):
    """A 2-page system prompt (pages of `ps` rows) under 4 tails (the last
    one a page, so the prompt is 3 full pages), a repeat of that prompt (a
    full cover: its last page is copied on write) and one unshared
    prompt; with their budgets."""
    sys_p = draw_prompts(cfg, [2 * ps], seed=10)[0]
    tails = draw_prompts(cfg, [3, 7, 5, ps], seed=20)
    out = [np.concatenate([sys_p, t]) for t in tails]
    out += [out[3].copy(), draw_prompts(cfg, [13], seed=30)[0]]
    return out, [6, 8, 5, 7, 6, 5]


def serve_engine(engine, request, prompts, budgets, midflight=True):
    """Submit every prompt to `engine` (either package's), the first two
    up front and the rest after one step, and drain it."""
    for uid, (p, b) in enumerate(zip(prompts, budgets)):
        engine.submit(request(uid, p, max_new_tokens=b))
        if midflight and uid == 1:
            engine.step()
    return {u: r.output for u, r in engine.run().items()}


def jax_engine(runs, cj, jparams, prompts, budgets, **kw):
    """JAX's engine (2 slots, max_len 48; `kw`: its ServeConfig fields) on
    the trace: tokens, stats and admission steps, from `runs` (a dict a
    module fixture holds, so the port's modes share one run) when already
    made."""
    from repro.serve import InferenceEngine, Request, ServeConfig
    key = (cj.name, cj.first_k_dense, id(jparams), tuple(sorted(kw.items())))
    if key not in runs:
        eng = InferenceEngine(jparams, cj, ServeConfig(greedy=True, **kw),
                              max_batch=2, max_len=48)
        runs[key] = (serve_engine(eng, Request, prompts, budgets),
                     dict(eng.stats), dict(eng.admission_step))
    return runs[key]


def drained(eng):
    """The port's engine after its run: no page mapped, only the prefix
    index's pages in use, every table zero, the pool empty once the index
    is cleared."""
    assert not eng.kv.ref.any(), "a drained engine maps no page"
    assert eng.kv.used_pages == eng.kv.cached_page_count
    assert not eng.kv.tables["linear"].any()
    eng.check_invariants()
    if eng.prefix is not None:
        eng.prefix.clear()
    assert eng.kv.used_pages == 0


def same_tokens(want, got):
    assert sorted(want) == sorted(got)
    for u in want:
        np.testing.assert_array_equal(want[u], got[u], err_msg=f"uid {u}")


def bits(a) -> np.ndarray:
    """A leaf of either package as numpy words of its stored bits: packed
    words as int32, bf16 as int16."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def leaves_equal(want, got):
    """Two parameter trees (either package's) hold the same leaves, bit
    for bit, in JAX's flattening order."""
    import jax
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in want] == \
        [jax.tree_util.keystr(k) for k, _ in got]
    for (kp, a), (_, b) in zip(want, got):
        a, b = bits(a), bits(b)
        assert a.dtype == b.dtype, jax.tree_util.keystr(kp)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(kp))


def flat_templates(want, got):
    """(path, shape, dtype) of every leaf of JAX's template and the
    port's, in JAX's flattening order."""
    import jax
    from repro_torch.quant.surgery import LeafSpec
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, LeafSpec))[0]
    return ([(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
             for k, v in flat_w],
            [(jax.tree_util.keystr(k), tuple(v.shape), v.dtype)
             for k, v in flat_g])
