"""Global model registry of the PyTorch port.

Counterpart of ``deepfake_detection_tpu/registry.py`` (same API, own copy):
model names map to entrypoint callables that build ``nn.Module``s.  The
registry is the single namespace through which every backbone is
constructed, so runner code never imports model files directly.
"""

from __future__ import annotations

import fnmatch
import re
import sys
from typing import Callable, Dict, List, Set

__all__ = [
    "register_model",
    "list_models",
    "is_model",
    "model_entrypoint",
    "list_modules",
    "is_model_in_modules",
]

_model_entrypoints: Dict[str, Callable] = {}
_model_to_module: Dict[str, str] = {}
_module_to_models: Dict[str, Set[str]] = {}


def register_model(fn: Callable) -> Callable:
    """Decorator: registers ``fn`` under its function name.

    The entrypoint signature convention is
    ``fn(pretrained: bool = False, **kwargs) -> nn.Module``.
    """
    name = fn.__name__
    module_name = fn.__module__.split(".")[-1]
    if name in _model_entrypoints:
        raise ValueError(f"Model {name!r} is already registered "
                         f"(by module {_model_to_module[name]!r})")
    _model_entrypoints[name] = fn
    _model_to_module[name] = module_name
    _module_to_models.setdefault(module_name, set()).add(name)
    # mirror onto the defining module's __all__ for introspection
    mod = sys.modules.get(fn.__module__)
    if mod is not None:
        if hasattr(mod, "__all__"):
            if name not in mod.__all__:
                mod.__all__.append(name)
        else:
            mod.__all__ = [name]
    return fn


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def list_models(filter: str = "", module: str = "", exclude_filters=()) -> List[str]:
    """All registered model names, optionally glob-filtered / module-scoped."""
    if module:
        names = list(_module_to_models.get(module, set()))
    else:
        names = list(_model_entrypoints.keys())
    if filter:
        names = fnmatch.filter(names, filter)
    if exclude_filters:
        if isinstance(exclude_filters, str):
            exclude_filters = [exclude_filters]
        for xf in exclude_filters:
            drop = set(fnmatch.filter(names, xf))
            names = [n for n in names if n not in drop]
    return sorted(names, key=_natural_key)


def is_model(name: str) -> bool:
    return name in _model_entrypoints


def model_entrypoint(name: str) -> Callable:
    try:
        return _model_entrypoints[name]
    except KeyError:
        raise KeyError(
            f"Unknown model {name!r}. Known models: {list_models()[:20]} ...") from None


def list_modules() -> List[str]:
    return sorted(_module_to_models.keys())


def is_model_in_modules(name: str, modules) -> bool:
    if not isinstance(modules, (tuple, list, set)):
        raise TypeError(f"modules must be a tuple, list or set, got {type(modules)}")
    return any(name in _module_to_models.get(m, set()) for m in modules)
