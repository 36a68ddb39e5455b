"""Architecture registry, the port of ``repro.api.archs``: each
``repro_torch/configs/<arch>.py`` registers a zero-arg factory of an
:class:`ArchSpec` with ``@register_arch``, and other packages can
register their own archs the same way::

    from repro_torch.api import ArchSpec, register_arch

    @register_arch("my-model-1b")
    def _spec():
        return ArchSpec("my-model-1b", config=CONFIG, smoke=SMOKE,
                        shapes=("train_4k", "decode_32k"))

Factories are resolved (and memoized) on first lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple, Union

from repro_torch.api.registry import Registry
from repro_torch.models.config import ModelConfig

ARCHS = Registry("arch")
register_arch = ARCHS.register


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One architecture: its published config, its smoke-scale config,
    and the names of the input-shape cells it runs (``train_4k``,
    ``prefill_32k``, ``decode_32k``, ``long_500k``)."""
    name: str
    config: ModelConfig
    smoke: ModelConfig
    shapes: Tuple[str, ...]


_resolved: dict = {}


def _ensure_builtins() -> None:
    # importing repro_torch.configs registers every built-in arch module
    import repro_torch.configs  # noqa: F401


def get_arch(name: str) -> ArchSpec:
    _ensure_builtins()
    entry: Union[ArchSpec, Callable[[], ArchSpec]] = ARCHS.get(name)
    cached = _resolved.get(name)
    if cached is None or cached[0] is not entry:   # re-registered: refresh
        spec = entry() if callable(entry) else entry
        if not isinstance(spec, ArchSpec):
            raise TypeError(f"arch {name!r} registered a "
                            f"{type(spec).__name__}, expected ArchSpec")
        _resolved[name] = (entry, spec)
    return _resolved[name][1]


def list_archs() -> List[str]:
    _ensure_builtins()
    return ARCHS.names()


def get_config(name: str) -> ModelConfig:
    """Published full-scale config for `name`."""
    return get_arch(name).config


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke runs."""
    return get_arch(name).smoke


def shapes_for(name: str) -> List[str]:
    return list(get_arch(name).shapes)
