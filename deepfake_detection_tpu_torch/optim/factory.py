"""Optimizer factory.

Counterpart of ``deepfake_detection_tpu/optim/factory.py``: the same names
(sgd, adam, adamw, nadam, radam, adadelta, rmsprop, rmsproptf, novograd,
nvnovograd, lamb), the ``lookahead_`` prefix (:class:`.Lookahead`), the
apex ``fused*`` aliases (``fusedadam`` → adam, ``fused`` → sgd, ...), and
the adamw/radam weight decay divided by the lr (the reference keeps the
effective decay constant that way).  Each computes what the JAX package's
optax chain computes, not what ``torch.optim``'s namesake does:

* ``rmsproptf``: :class:`RMSpropTF` (alpha 0.9, TF semantics);
* ``rmsprop``: ``optax.rmsprop(decay=0.9, momentum=...)``, which is
  :class:`RMSpropTF` with a zero-initial accumulator;
* ``sgd``: ``torch.optim.SGD`` with Nesterov momentum, its momentum
  buffers made at construction;
* ``adam``, ``adamw``, ``nadam``, ``radam``: :class:`.Adam`;
  ``adadelta``: :class:`.Adadelta`; ``lamb``: :class:`.Lamb`;
  ``novograd``: :class:`.NovoGrad` (optax's); ``nvnovograd``:
  :class:`.NvNovoGrad` (NVIDIA's).

Every state tensor exists after construction, so a train step can roll it
back.  The JAX package's weight-decay mask (decay only parameters with
``ndim > 1``: conv and dense kernels, not biases or norm parameters)
becomes two parameter groups.  Weight decay is coupled (added to the
gradient) wherever the JAX chain puts ``add_decayed_weights`` before the
optimizer; adamw and lamb add it to the direction, the NovoGrads to the
normalized gradient.  A name outside the JAX factory's raises
``ValueError``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .adadelta import Adadelta
from .adam import Adam
from .lamb import Lamb
from .lookahead import Lookahead
from .novograd import NovoGrad
from .nvnovograd import NvNovoGrad
from .rmsprop_tf import RMSpropTF

__all__ = ["create_optimizer", "param_groups", "KNOWN"]

KNOWN = ("sgd", "adam", "adamw", "nadam", "radam", "adadelta", "rmsprop",
         "rmsproptf", "novograd", "nvnovograd", "lamb")


def param_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """``[decayed, not decayed]`` groups by the JAX package's mask; one
    group without decay when ``weight_decay`` is 0."""
    params = [p for p in model.parameters() if p.requires_grad]
    if not weight_decay:
        return [dict(params=params, weight_decay=0.0)]
    return [dict(params=[p for p in params if p.dim() > 1],
                 weight_decay=weight_decay),
            dict(params=[p for p in params if p.dim() <= 1],
                 weight_decay=0.0)]


def _base_name(opt: str) -> str:
    """The JAX factory's name resolution: the last ``_`` part, a ``fused``
    prefix stripped (``fused`` alone is sgd)."""
    name = opt.lower().split("_")[-1]
    if name.startswith("fused"):
        name = name[len("fused"):] or "sgd"
    if name not in KNOWN:
        raise ValueError(f"Invalid optimizer {opt!r}")
    return name


def _base_optimizer(name: str, groups: List[dict], lr: float, eps: float,
                    momentum: float) -> torch.optim.Optimizer:
    if name in ("rmsproptf", "rmsprop"):
        return RMSpropTF(groups, lr=lr, alpha=0.9, eps=eps,
                         momentum=momentum,
                         initial_square_avg=1.0 if name == "rmsproptf"
                         else 0.0)
    if name == "sgd":
        opt = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                              nesterov=momentum > 0)
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt
    if name in ("adam", "adamw", "nadam", "radam"):
        return Adam(groups, lr=lr, eps=eps, decoupled=name == "adamw",
                    nesterov=name == "nadam", rectify=name == "radam")
    if name == "adadelta":
        return Adadelta(groups, lr=lr, eps=eps)
    if name == "novograd":
        return NovoGrad(groups, lr=lr, eps=eps)
    if name == "nvnovograd":
        return NvNovoGrad(groups, lr=lr, eps=eps)
    return Lamb(groups, lr=lr, eps=eps)


def create_optimizer(cfg, model: nn.Module,
                     lr: float) -> torch.optim.Optimizer:
    """The optimizer named by ``cfg.opt`` over ``model``'s parameters;
    ``cfg`` needs ``opt``, ``opt_eps``, ``momentum`` and ``weight_decay``."""
    opt = cfg.opt.lower()
    name = _base_name(opt)
    weight_decay = cfg.weight_decay
    if ("adamw" in opt or "radam" in opt) and weight_decay and lr:
        weight_decay = weight_decay / lr
    tx = _base_optimizer(name, param_groups(model, weight_decay), lr,
                         cfg.opt_eps, cfg.momentum)
    parts = opt.split("_")
    if len(parts) > 1 and parts[0] == "lookahead":
        tx = Lookahead(tx)
    return tx
