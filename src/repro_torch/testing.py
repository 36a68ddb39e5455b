"""Packed parameter trees drawn from a seed, for the tests and
``chip_smoke.py``: the repo holds no weights, so a model of a published
shape is built from :func:`repro_torch.quant.surgery.abstract_quantized_params`
filled with random words and scales. No serving path uses this module.

Both fillers draw from the same distributions, scaled so activations
stay O(1) through any depth: packed words uniform; s2 ≈ 1/√K and s1 ≈
1/√R times N(1, 0.1); the embedding N(0, 0.02); norms N(1, 0.1); FP
weights N(0, 1/d_in); biases N(0, 0.02). :func:`random_packed_params`
draws on the host with numpy (the CPU parity tests hand its arrays to
both packages); :func:`random_packed_params_device` draws on the card, one
leaf at a time, for full-size models whose host draw would take tens of
GB and minutes. The two give different numbers from one seed."""
import numpy as np
import torch


def _normal_law(name, shape, packed):
    """(mean, std) of a floating leaf: the leaf is mean + std · N(0, 1)."""
    if packed and name == "s2":
        mean = 1.0 / np.sqrt(shape[-1])
        return mean, 0.1 * mean
    if packed and name == "s1":
        mean = 1.0 / np.sqrt(32 * packed["qu_t"].shape[-2])
        return mean, 0.1 * mean
    if name in ("embed", "b"):
        return 0.0, 0.02
    if name == "w":
        return 0.0, 1.0 / np.sqrt(shape[-2])
    return 1.0, 0.1                             # norm weights


def _walk(tree, fill, packed=None):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _walk(v, fill, v if "qu_t" in v else None)
        else:
            out[k] = fill(k, tuple(v.shape), v.dtype, packed)
    return out


def random_packed_params(template, seed: int):
    """Fill a template (:func:`abstract_quantized_params` /
    :func:`param_specs`) with numpy arrays from
    ``numpy.random.default_rng(seed)``. Floating leaves come back as
    float32 (cast them with ``convert.params_from_numpy(dtype=)``);
    packed words as uint32."""
    rng = np.random.default_rng(seed)

    def fill(name, shape, dtype, packed):
        if dtype == "uint32":
            return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        mean, std = _normal_law(name, shape, packed)
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    return _walk(template, fill)


def random_packed_params_device(template, seed: int, device="cuda"):
    """Fill a template on `device` from a ``torch.Generator`` seeded with
    `seed`, one leaf at a time: packed words as int32 (the port's layout),
    floating leaves as float32 (cast a model's FP leaves with
    ``convert.params_from_numpy(tree, device, dtype)``, which also takes
    tensors and leaves the packed ones shared)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def fill(name, shape, dtype, packed):
        if dtype == "uint32":
            return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                                 generator=gen, device=device)
        mean, std = _normal_law(name, shape, packed)
        return torch.randn(shape, generator=gen, device=device
                           ).mul_(float(std)).add_(float(mean))

    return _walk(template, fill)
