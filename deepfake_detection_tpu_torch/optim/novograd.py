"""NovoGrad with optax's semantics.

Counterpart of the JAX factory's ``novograd`` (``optax.novograd``, which
matches the reference's ``optim/novograd.py``): a per-tensor scalar
second moment ``ν`` of ``‖g‖²``, set to it on the first step and then
``(1 - b2)·‖g‖² + b2·ν``; the first moment ``m = g/(√ν + eps) + wd·p`` on
the first step, then ``b1·m`` plus it; the step ``-lr·m``.  Weight decay
is built in (it acts on the normalized gradient), so the factory's mask
is the groups' ``weight_decay``.
"""

from __future__ import annotations

import torch

from .base import ForeachOptimizer

__all__ = ["NovoGrad"]


class NovoGrad(ForeachOptimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.25),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"lr={lr} eps={eps} weight_decay="
                             f"{weight_decay} must be >= 0")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p)
        st["exp_avg_sq"] = torch.zeros((), dtype=p.dtype, device=p.device)

    def _deltas(self, group, params, grads, states, count):
        b1, b2 = group["betas"]
        first = count == 1
        nu = [s["exp_avg_sq"] for s in states]
        norm = torch.stack(torch._foreach_norm(grads))
        sq = norm * norm
        nu_new = torch.where(first, sq, (1.0 - b2) * sq
                             + b2 * torch.stack(nu))
        torch._foreach_copy_(nu, nu_new.unbind())
        m_add = torch._foreach_div(grads, (torch.sqrt(nu_new)
                                           + group["eps"]).unbind())
        if group["weight_decay"]:
            torch._foreach_add_(m_add, torch._foreach_mul(
                params, group["weight_decay"]))
        mu = [s["exp_avg"] for s in states]
        # b1·m + m_add after the first step, m_add on it (m is 0 there)
        torch._foreach_mul_(mu, b1 * (~first).to(norm.dtype))
        torch._foreach_add_(mu, m_add)
        return self._scale_lr(mu, group["lr"])
