"""Generic decorator-based registries, the port's copy of
``repro.api.registry``.

A :class:`Registry` maps string names to objects (or zero-arg factories)
and raises :class:`UnknownNameError` — a ``KeyError`` that lists every
available name — on a miss, so callers always get an
actionable message instead of a bare dispatch failure.

The module imports nothing of the package: it sits below every layer
that registers into it and above none, so init-method modules
self-register without import cycles.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class UnknownNameError(KeyError):
    """Lookup miss in a registry; message carries the available names."""

    def __init__(self, kind: str, name: str, available: List[str]):
        self.kind, self.name, self.available = kind, name, available
        super().__init__(
            f"unknown {kind} {name!r}; available: {sorted(available)}")

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0]


class Registry:
    """Name -> object mapping with decorator registration.

    ``register`` can be used three ways::

        reg.register("name", obj)          # direct

        @reg.register("name")              # decorator with explicit name
        def obj(...): ...

        @reg.register                      # decorator, name = __name__
        def obj(...): ...
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name_or_obj: Any = None, obj: Any = None,
                 *, overwrite: bool = False) -> Any:
        if callable(name_or_obj) and obj is None \
                and not isinstance(name_or_obj, str):
            return self._add(name_or_obj.__name__, name_or_obj, overwrite)
        name = name_or_obj
        if obj is not None:
            return self._add(name, obj, overwrite)

        def deco(o):
            return self._add(name, o, overwrite)
        return deco

    def _add(self, name: str, obj: Any, overwrite: bool) -> Any:
        if not overwrite and name in self._items \
                and self._items[name] is not obj:
            raise ValueError(
                f"{self.kind} {name!r} already registered; pass "
                f"overwrite=True to replace it")
        self._items[name] = obj
        return obj

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise UnknownNameError(self.kind, name, self.names()) from None

    def unregister(self, name: str) -> None:
        self._items.pop(name, None)

    def names(self) -> List[str]:
        return list(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __len__(self) -> int:
        return len(self._items)
