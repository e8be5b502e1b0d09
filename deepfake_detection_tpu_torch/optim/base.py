"""The base of the port's optax-semantics optimizers.

The JAX package's optimizers are optax transformations; a few of them
(nadam, radam, adadelta, novograd, lamb) compute something else than
``torch.optim``'s namesakes, so the port writes each as an
:class:`ForeachOptimizer`: every state tensor is made at construction
(moments and a per-parameter ``count``, float32, optax's step counter), so
``TrainState.flat_buffers`` covers it, the non-finite guard rolls it back
with the rest of the state, and a checkpoint saves and restores it.  A
subclass computes each group's final deltas (already scaled by ``-lr``, as
optax's ``scale_by_learning_rate``) with ``torch._foreach_*`` ops; the base
adds them to the parameters.  Nothing reads a device value back to the
host.  All counts of a group advance together, so the first one stands
for the group's step (optax has one count for the whole tree).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.optim import Optimizer

__all__ = ["ForeachOptimizer", "coupled_decay"]


def coupled_decay(grads: List[torch.Tensor], params: List[torch.Tensor],
                  weight_decay: float) -> List[torch.Tensor]:
    """optax's ``add_decayed_weights``: ``g + wd · p`` (the group's share of
    the decay mask is its ``weight_decay``)."""
    if not weight_decay:
        return grads
    return torch._foreach_add(grads, torch._foreach_mul(params,
                                                        weight_decay))


class ForeachOptimizer(Optimizer):
    def __init__(self, params, defaults: Dict):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["count"] = torch.zeros((), dtype=torch.float32,
                                          device=p.device)
                self._init_state(p, st)

    def _init_state(self, p: torch.Tensor, st: Dict) -> None:
        raise NotImplementedError

    def _deltas(self, group: Dict, params: List[torch.Tensor],
                grads: List[torch.Tensor], states: List[Dict],
                count: torch.Tensor) -> List[torch.Tensor]:
        """The deltas ``params`` move by; ``count`` is the step being taken
        (1 on the first)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            counts = [s["count"] for s in states]
            torch._foreach_add_(counts, 1.0)
            deltas = self._deltas(group, params, [p.grad for p in params],
                                  states, counts[0])
            torch._foreach_add_(params, deltas)
        return loss

    @staticmethod
    def _scale_lr(updates: List[torch.Tensor], lr: float
                  ) -> List[torch.Tensor]:
        return torch._foreach_mul(updates, -lr)
