"""NVIDIA's NovoGrad.

Counterpart of ``deepfake_detection_tpu/optim/nvnovograd.py`` (the
reference's ``optim/nvnovograd.py``, without amsgrad), distinct from
optax's :mod:`.novograd`:

* a per-tensor scalar ``exp_avg_sq``, the EMA of ``Σ g²`` with ``b2``,
  set to ``Σ g²`` while it is still exactly 0 (the reference checks the
  value, not the step);
* ``g ← g / (√exp_avg_sq + eps) + wd·p``;
* ``exp_avg ← b1·exp_avg + g`` (no ``1 - b1`` factor), no bias
  correction, ``p ← p - lr·exp_avg``.
"""

from __future__ import annotations

import torch

from .base import ForeachOptimizer

__all__ = ["NvNovoGrad"]


class NvNovoGrad(ForeachOptimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.95, 0.98),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"lr={lr} eps={eps} weight_decay="
                             f"{weight_decay} must be >= 0")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p)
        st["exp_avg_sq"] = torch.zeros((), dtype=torch.float32,
                                       device=p.device)

    def _deltas(self, group, params, grads, states, count):
        b1, b2 = group["betas"]
        v = [s["exp_avg_sq"] for s in states]
        norm = torch.stack(torch._foreach_norm(grads)).float()
        sq = norm * norm
        old = torch.stack(v)
        v_new = torch.where(old == 0.0, sq, b2 * old + (1.0 - b2) * sq)
        torch._foreach_copy_(v, v_new.unbind())
        normed = torch._foreach_div(grads, (torch.sqrt(v_new)
                                            + group["eps"]).unbind())
        if group["weight_decay"]:
            torch._foreach_add_(normed, torch._foreach_mul(
                params, group["weight_decay"]))
        m = [s["exp_avg"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, normed)
        return self._scale_lr(m, group["lr"])
