"""Lookahead (k steps forward, one back) around any port optimizer.

Counterpart of ``deepfake_detection_tpu/optim/lookahead.py``, selected by
the factory's ``lookahead_`` prefix: the inner optimizer steps as usual,
and every ``sync_period``-th step the parameters land on ``slow + alpha ·
(fast - slow)``, which becomes the new slow copy.  The slow copy and the
step counter live in the inner optimizer's state (made at construction,
per parameter), which this wrapper shares, so the train state's flat
buffers, the non-finite guard and checkpoints cover them.  The sync is a
device select: nothing is read back to the host.
"""

from __future__ import annotations

import torch
from torch.optim import Optimizer

__all__ = ["Lookahead"]


class Lookahead(Optimizer):
    def __init__(self, inner: Optimizer, sync_period: int = 6,
                 alpha: float = 0.5):
        if sync_period < 1 or not 0.0 <= alpha <= 1.0:
            raise ValueError(f"sync_period={sync_period} alpha={alpha}")
        super().__init__([p for g in inner.param_groups
                          for p in g["params"]], {})
        self.inner = inner
        self.sync_period = sync_period
        self.alpha = alpha
        self._share()
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["lookahead_slow"] = p.detach().clone()
                st["lookahead_count"] = torch.zeros(
                    (), dtype=torch.float32, device=p.device)

    def _share(self) -> None:
        """One set of param groups and one state for both optimizers."""
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state
        self.defaults = self.inner.defaults

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self.inner.param_groups = self.param_groups
        self.inner.state = self.state

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.inner.step(closure)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            counts = [s["lookahead_count"] for s in states]
            torch._foreach_add_(counts, 1.0)
            sync = (torch.remainder(counts[0], self.sync_period) == 0
                    ).to(params[0].dtype)
            slow = [s["lookahead_slow"] for s in states]
            # slow += sync·alpha·(fast - slow); fast += sync·(slow - fast)
            d = torch._foreach_sub(params, slow)
            torch._foreach_mul_(d, sync * self.alpha)
            torch._foreach_add_(slow, d)
            e = torch._foreach_sub(slow, params)
            torch._foreach_mul_(e, sync)
            torch._foreach_add_(params, e)
        return loss
