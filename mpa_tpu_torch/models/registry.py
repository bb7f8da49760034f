"""String-addressed model registry (counterpart of ``mpa_tpu/models/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(ctor: Callable):
        if name in _REGISTRY:
            raise ValueError(f"model '{name}' already registered")
        _REGISTRY[name] = ctor
        return ctor

    return deco


def get_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models():
    return sorted(_REGISTRY)
