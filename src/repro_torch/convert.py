"""Numpy parameter trees -> the port's tensors.

The JAX package's parameter tree, as numpy arrays (``np.asarray`` of
each leaf, or what an artifact's npz shards hold), becomes a nested dict
of torch tensors. Packed ``uint32`` words become ``int32`` tensors with
the same bits (see :mod:`repro_torch.kernels.ref`); ``bfloat16`` leaves
(numpy carries them through ``ml_dtypes`` or as raw 16-bit words) become
``torch.bfloat16`` with the same bits.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

# dtype names numpy cannot hold natively -> torch dtype of the same width
_EXTENDED = {"bfloat16": torch.bfloat16}


def tensor_from_numpy(arr: np.ndarray,
                      dtype_name: Optional[str] = None) -> torch.Tensor:
    """One leaf, bit-exact. ``dtype_name`` names the true dtype when
    `arr` holds raw bits of a dtype numpy lacks (how the checkpoint
    stores bfloat16); by default it is ``arr.dtype.name``."""
    name = dtype_name or arr.dtype.name
    arr = np.ascontiguousarray(arr)
    if name in _EXTENDED:
        bits = arr.view(np.int16) if arr.dtype.itemsize == 2 else arr
        return torch.from_numpy(bits.copy()).view(_EXTENDED[name])
    if name == "uint32":
        return torch.from_numpy(arr.view(np.int32).copy())
    return torch.from_numpy(arr.astype(np.dtype(name), copy=True))


def params_from_numpy(tree: Any, device, dtype: Optional[torch.dtype] = None):
    """Map a nested dict of numpy arrays to tensors on `device`. `dtype`
    (optional) casts the model's floating FP leaves (embeddings, norms,
    FP linears); the leaves of a packed linear keep their stored dtype
    (f32 scales, int32 words)."""
    device = torch.device(device)

    def conv(node, packed):
        if isinstance(node, dict):
            inner = packed or "qu_t" in node
            return {k: conv(v, inner) for k, v in node.items()}
        t = node if isinstance(node, torch.Tensor) else \
            tensor_from_numpy(np.asarray(node))
        if dtype is not None and not packed and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(tree, False)
