"""Numpy parameter trees -> the port's tensors.

The JAX package's parameter tree, as numpy arrays (``np.asarray`` of
each leaf, or what an artifact's npz shards hold), becomes a nested dict
of torch tensors. Packed ``uint32`` words become ``int32`` tensors with
the same bits (see :mod:`repro_torch.kernels.ref`); ``bfloat16`` leaves
(numpy carries them through ``ml_dtypes`` or as raw 16-bit words) become
``torch.bfloat16`` with the same bits. :func:`numpy_from_tensor` is the
inverse, for writing an artifact.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

# dtype names numpy cannot hold natively -> torch dtype of the same width
_EXTENDED = {"bfloat16": torch.bfloat16}
# FP leaves that stay float32 in a model of any dtype, as in the JAX
# package: the MoE router, and the Mamba2 mixer's A_log, D and dt_bias
KEEP_F32 = frozenset({"router", "A_log", "D", "dt_bias"})


def tensor_from_numpy(arr: np.ndarray,
                      dtype_name: Optional[str] = None) -> torch.Tensor:
    """One leaf, bit-exact. ``dtype_name`` names the true dtype when
    `arr` holds raw bits of a dtype numpy lacks (how the checkpoint
    stores bfloat16); by default it is ``arr.dtype.name``."""
    name = dtype_name or arr.dtype.name
    # ascontiguousarray returns at least one dimension: keep a 0-d leaf
    # (a VLM cross block's gates, alone in a journaled block) 0-d
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if name in _EXTENDED:
        bits = arr.view(np.int16) if arr.dtype.itemsize == 2 else arr
        return torch.from_numpy(bits.copy()).view(_EXTENDED[name])
    if name == "uint32":
        return torch.from_numpy(arr.view(np.int32).copy())
    return torch.from_numpy(arr.astype(np.dtype(name), copy=True))


def numpy_from_tensor(t: torch.Tensor, dtype_name: Optional[str] = None
                      ) -> Tuple[np.ndarray, str]:
    """One leaf back to numpy, bit-exact, as the checkpoint stores it:
    (array, true dtype name). ``bfloat16`` comes back as its raw 16-bit
    words; an int32 leaf named ``"uint32"`` (packed words) as uint32 with
    the same bits."""
    t = t.detach().contiguous().cpu()
    name = dtype_name or str(t.dtype).removeprefix("torch.")
    if t.dtype in _EXTENDED.values():
        return t.view(torch.int16).numpy().view(np.uint16), name
    arr = t.numpy()
    if name == "uint32" and arr.dtype == np.int32:
        return arr.view(np.uint32), name
    return arr, name


def params_from_numpy(tree: Any, device, dtype: Optional[torch.dtype] = None):
    """Map a nested dict of numpy arrays to tensors on `device`. `dtype`
    (optional) casts the model's floating FP leaves (embeddings, norms,
    FP linears); the leaves of a packed linear keep their stored dtype
    (f32 scales, int32 words), and so do those of :data:`KEEP_F32` (the
    MoE router, the Mamba2 mixer's A_log, D and dt_bias: f32)."""
    device = torch.device(device)

    def conv(node, keep):
        if isinstance(node, dict):
            return {k: conv(v, keep or "qu_t" in node or k in KEEP_F32)
                    for k, v in node.items()}
        t = node if isinstance(node, torch.Tensor) else \
            tensor_from_numpy(np.asarray(node))
        if dtype is not None and not keep and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(tree, False)
