"""Dense-family architecture configs the port serves (``get_config`` /
``get_smoke`` / ``list_archs``), copied from ``repro.configs``.

Each ``<arch>.py`` module defines ``CONFIG`` (the published full-scale
configuration) and ``SMOKE`` (a reduced same-family config for CPU
tests)."""
from __future__ import annotations

from typing import List

from repro_torch.configs import llama3p2_1b, qwen1p5_0p5b, qwen1p5_110b, qwen3_4b
from repro_torch.models.config import ModelConfig

_ARCHS = {m.CONFIG.name: m for m in (llama3p2_1b, qwen1p5_0p5b,
                                     qwen1p5_110b, qwen3_4b)}


def list_archs() -> List[str]:
    return sorted(_ARCHS)


def _module(arch: str):
    try:
        return _ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{list_archs()}") from None


def get_config(arch: str) -> ModelConfig:
    """Published full-scale config for `arch`."""
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke runs."""
    return _module(arch).SMOKE
