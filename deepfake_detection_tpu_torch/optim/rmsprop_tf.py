"""RMSprop with TensorFlow's semantics.

Counterpart of ``deepfake_detection_tpu/optim/rmsprop_tf.py`` (the
reference's ``--opt rmsproptf``).  It differs from ``torch.optim.RMSprop``
in the ways that matter for matching the reference's convergence:

1. the squared-gradient accumulator starts at **ones** (``initial_square_avg``;
   0 gives the JAX package's ``--opt rmsprop``);
2. eps goes **inside** the square root, ``sqrt(avg + eps)``;
3. with momentum the **learning rate is folded into the momentum buffer**,
   ``buf = m · buf + lr · g / rms`` and ``p -= buf``, as TF accumulates it;
4. coupled (L2) weight decay is added to the gradient before the
   accumulator: ``g += wd · p``.

The state is made at construction (every parameter gets its buffers at
once), so a train step can snapshot and roll it back before the first
update.  The update runs as ``torch._foreach_*`` ops over each group.
(The JAX version's ``centered`` and ``lr_in_momentum=False`` variants have
no caller and are not ported.)
"""

from __future__ import annotations

import torch
from torch.optim import Optimizer

__all__ = ["RMSpropTF"]


class RMSpropTF(Optimizer):
    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.9,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 momentum: float = 0.9, initial_square_avg: float = 1.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0 or momentum < 0.0:
            raise ValueError(f"lr={lr} eps={eps} weight_decay={weight_decay} "
                             f"momentum={momentum} must be >= 0")
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay,
                                      momentum=momentum))
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["square_avg"] = torch.full_like(
                    p, initial_square_avg, memory_format=torch.preserve_format)
                st["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

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
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            lr, alpha, eps = group["lr"], group["alpha"], group["eps"]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            sq = [s["square_avg"] for s in states]
            # square_avg += (1 - alpha) · (g² - square_avg)
            diff = torch._foreach_sub(torch._foreach_mul(grads, grads), sq)
            torch._foreach_mul_(diff, 1.0 - alpha)
            torch._foreach_add_(sq, diff)
            rms = torch._foreach_add(sq, eps)
            torch._foreach_sqrt_(rms)
            # (lr · g) / rms, folded into the momentum buffer when there is one
            step = torch._foreach_div(torch._foreach_mul(grads, lr), rms)
            if group["momentum"] > 0:
                buf = [s["momentum_buffer"] for s in states]
                torch._foreach_mul_(buf, group["momentum"])
                torch._foreach_add_(buf, step)
                step = buf
            torch._foreach_sub_(params, step)
        return loss
