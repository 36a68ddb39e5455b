"""Packed parameter trees drawn from a seed, for the tests and
``chip_smoke.py``: the repo holds no weights, so a model of a published
shape is built from :func:`repro_torch.quant.surgery.abstract_quantized_params`
filled with random words and scales. No serving path uses this module."""
import numpy as np


def random_packed_params(template, seed: int):
    """Fill a template (:func:`abstract_quantized_params` /
    :func:`param_specs`) with numpy arrays from
    ``numpy.random.default_rng(seed)``, scaled so activations stay O(1)
    through any depth: packed words uniform; s2 ≈ 1/√K and s1 ≈ 1/√R
    times N(1, 0.1); the embedding N(0, 0.02); norms N(1, 0.1); FP
    weights N(0, 1/d_in); biases N(0, 0.02). Floating leaves come back as
    float32 (cast them with ``convert.params_from_numpy(dtype=)``);
    packed words as uint32."""
    rng = np.random.default_rng(seed)

    def jitter(shape):
        return 1.0 + 0.1 * rng.standard_normal(shape)

    def fill(name, spec, packed):
        shape = tuple(spec.shape)
        if spec.dtype == "uint32":
            return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        if packed and name == "s2":
            a = jitter(shape) / np.sqrt(shape[-1])
        elif packed and name == "s1":
            a = jitter(shape) / np.sqrt(32 * packed["qu_t"].shape[-2])
        elif name == "embed":
            a = 0.02 * rng.standard_normal(shape)
        elif name == "w":
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        elif name == "b":
            a = 0.02 * rng.standard_normal(shape)
        else:                                   # norm weights
            a = jitter(shape)
        return a.astype(np.float32)

    def walk(tree, packed=None):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v, v if "qu_t" in v else None)
            else:
                out[k] = fill(k, v, packed)
        return out

    return walk(template)
