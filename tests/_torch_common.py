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
