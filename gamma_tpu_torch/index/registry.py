"""Name→factory registry (reference: index/reflector.{h,cc} — the
REGISTER_MODEL static-init macro becomes a decorator)."""

from __future__ import annotations

from typing import Callable, Dict, List, Type

_REGISTRY: Dict[str, type] = {}


def register_model(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _REGISTRY[name.upper()] = cls
        cls.model_name = name.upper()
        return cls
    return deco


def create_model(name: str, *args, **kwargs):
    cls = _REGISTRY.get(name.upper())
    if cls is None:
        raise KeyError(f"unknown retrieval model {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return cls(*args, **kwargs)


def model_names() -> List[str]:
    return sorted(_REGISTRY)
