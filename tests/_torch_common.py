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
        for leaf in ("k", "v"):
            assert_close(jcache[stack][leaf], tcache[stack][leaf], tolerance,
                         f"prefill cache {stack}/{leaf} ({what})")


def check_paged_decode(cfg, jparams, tparams, policy, tolerance, what):
    """One batched decode step over a paged pool (one per block stack)
    with ragged tables and an inactive (all-null) slot."""
    import jax
    from repro.models import transformer as JT
    from repro_torch.kernels.ops import kernel_policy
    from repro_torch.models import transformer as TT
    rng = np.random.default_rng(3)
    PS, hkv, hd = 4, cfg.n_kv_heads, cfg.head_dim
    pools = {name: rng.standard_normal((2, n, 10, PS, hkv, hd)
                                       ).astype(np.float32)
             for name, n in TT.stack_depths(cfg).items()}
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 5, 2], np.int32)
    tok = tokens(cfg, (3, 1), 4)

    def cache(lib):
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        return {name: {"k": conv(pool[0].copy()), "v": conv(pool[1].copy())}
                for name, pool in pools.items()}

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
        for leaf in ("k", "v"):
            # the inactive slot's write lands on the null page 0, whose
            # content is trash by design: compare the real pages only
            assert_close(jc[name][leaf][:, 1:], tc[name][leaf][:, 1:],
                         tolerance, f"decode pool {name}/{leaf} ({what})")
