"""NanoQuant serving in PyTorch with hand-written Hopper kernels — the
port of the JAX package ``repro``, which stays the reference.

The package imports ``torch`` and nothing of JAX or of ``repro``. Its
entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises for CUDA when no card is
    present — nothing falls back to the CPU on its own."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return d
