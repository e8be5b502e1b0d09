"""Activation functions + name resolver.

Counterpart of ``deepfake_detection_tpu/ops/activations.py``: the same names
resolve to the same functions, written as plain torch ops.  ``gelu`` is the
tanh approximation, which is what ``jax.nn.gelu`` computes by default.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["get_act_fn", "swish", "mish", "hard_swish", "hard_sigmoid",
           "hard_mish", "sigmoid", "ACT_FNS"]


def swish(x):
    """SiLU / Swish: x * sigmoid(x)."""
    return F.silu(x)


def mish(x):
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


def sigmoid(x):
    return torch.sigmoid(x)


def hard_swish(x):
    """x * relu6(x+3)/6."""
    return x * F.relu6(x + 3.0) / 6.0


def hard_sigmoid(x):
    """relu6(x+3)/6."""
    return F.relu6(x + 3.0) / 6.0


def hard_mish(x):
    return 0.5 * x * torch.clamp(x + 2.0, 0.0, 2.0)


ACT_FNS = {
    "swish": swish,
    "silu": swish,
    "mish": mish,
    "relu": F.relu,
    "relu6": F.relu6,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "hard_swish": hard_swish,
    "hard_sigmoid": hard_sigmoid,
    "hard_mish": hard_mish,
    "identity": lambda x: x,
    None: lambda x: x,
}


def get_act_fn(name) -> Callable:
    """Resolve an activation by name; callables pass through unchanged."""
    if callable(name):
        return name
    if name in ACT_FNS:
        return ACT_FNS[name]
    raise KeyError(f"Unknown activation {name!r}; known: {sorted(k for k in ACT_FNS if k)}")
