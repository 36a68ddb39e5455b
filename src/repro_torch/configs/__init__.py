"""Architecture configs (``--arch <id>``), copied from ``repro.configs``.

Each ``<arch>.py`` module defines ``CONFIG`` (the published full-scale
configuration), ``SMOKE`` (a reduced same-family config for CPU tests)
and ``SHAPES`` (the input-shape cells the arch runs), and registers
itself in the arch registry (``repro_torch.api.archs``) with
``@register_arch``. The accessors here delegate to that registry."""
from __future__ import annotations

from typing import List

from repro_torch.api import archs as _archs
from repro_torch.models.config import ModelConfig

# importing the arch modules registers them (decorator side effect), in
# the reference's order
from repro_torch.configs import (  # noqa: F401,E402
    deepseek_v2_lite, llama3p2_1b, llama3p2_vision_90b, mamba2_370m,
    musicgen_medium, qwen1p5_0p5b, qwen1p5_110b, qwen3_4b, qwen3_moe_235b,
    zamba2_1p2b)


def list_archs() -> List[str]:
    return _archs.list_archs()


def get_config(arch: str) -> ModelConfig:
    """Published full-scale config for `arch`."""
    return _archs.get_config(arch)


def get_smoke(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke runs."""
    return _archs.get_smoke(arch)


def shapes_for(arch: str) -> List[str]:
    return _archs.shapes_for(arch)
