"""Optimizer factory.

Counterpart of ``deepfake_detection_tpu/optim/factory.py`` for the
optimizers the flagship's training path uses:

* ``rmsproptf``: :class:`RMSpropTF` (alpha 0.9, TF semantics);
* ``rmsprop``: what the JAX package's ``optax.rmsprop(decay=0.9,
  momentum=...)`` computes, which is :class:`RMSpropTF` with a zero-initial
  accumulator (eps inside the square root, lr folded into the momentum);
* ``sgd``: ``torch.optim.SGD`` with Nesterov momentum, its momentum buffers
  made at construction so a train step can roll them back.

The JAX package's weight-decay mask (decay only parameters with ``ndim >
1``: conv and dense kernels, not biases or norm parameters) becomes two
parameter groups.  Weight decay is coupled (added to the gradient), as the
JAX package's ``add_decayed_weights`` before the optimizer.  Any other name
raises: the rest of the JAX factory (adam, adamw, nadam, radam, adadelta,
novograd, nvnovograd, lamb, lookahead) is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .rmsprop_tf import RMSpropTF

__all__ = ["create_optimizer", "param_groups"]

PORTED = ("rmsproptf", "rmsprop", "sgd")


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


def create_optimizer(cfg, model: nn.Module,
                     lr: float) -> torch.optim.Optimizer:
    """The optimizer named by ``cfg.opt`` over ``model``'s parameters;
    ``cfg`` needs ``opt``, ``opt_eps``, ``momentum`` and ``weight_decay``."""
    name = cfg.opt.lower()
    groups = param_groups(model, cfg.weight_decay)
    if name in ("rmsproptf", "rmsprop"):
        return RMSpropTF(groups, lr=lr, alpha=0.9, eps=cfg.opt_eps,
                         momentum=cfg.momentum,
                         initial_square_avg=1.0 if name == "rmsproptf"
                         else 0.0)
    if name == "sgd":
        opt = torch.optim.SGD(groups, lr=lr, momentum=cfg.momentum,
                              nesterov=cfg.momentum > 0)
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt
    raise NotImplementedError(
        f"--opt {cfg.opt}: the port has {', '.join(PORTED)}; the other "
        f"optimizers of the JAX package are ROADMAP Queue 1 item 6")
