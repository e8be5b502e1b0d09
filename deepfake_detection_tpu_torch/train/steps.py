"""Train and eval steps.

Counterparts of ``make_train_step`` / ``make_eval_step`` in
``deepfake_detection_tpu/train/steps.py`` without a mesh: one device.  A
step is forward in train mode → loss and top-1 → backward → gradient
clipping by global norm → optimizer step → EMA update, in place on the
:class:`TrainState`.  Metrics come back as device tensors; nothing in a step
reads a value back to the host, so the host can queue the next step while
the card runs this one.

``nonfinite_guard`` keeps a bad step from touching the state: the step
copies every tensor it may change (parameters, BN running stats, which the
forward updates, optimizer moments, EMA, the step counter) aside, and after
the update selects, on the device, the copy back wherever the loss or the
gradient norm is not finite.  The whole pre-step state survives bitwise;
``metrics["nonfinite"]`` is 1 for such a step.  (Zeroing NaN gradients
instead would still move RMSprop's moments.)  The state lives in one flat
buffer per dtype (``TrainState.flat_buffers``), so the copy and the select
are one kernel each: the flagship has ~3,800 state tensors, and one copy
or select per tensor cost more host time than the rest of the step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..losses import cross_entropy
from ..utils.metrics import accuracy
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "global_norm"]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over a list of tensors, as a device scalar."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def make_train_step(loss_fn: Callable = cross_entropy,
                    clip_grad: Optional[float] = None,
                    nonfinite_guard: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable:
    """Build ``train_step(state, x, y) -> metrics``.

    ``x`` is an NCHW batch (channels_last memory), ``y`` int labels or soft
    targets.  ``metrics`` holds device scalars ``loss`` and ``prec1``, and
    with the guard ``nonfinite`` and ``gnorm`` (the clipped gradients'
    norm).  ``generator`` drives drop_path/dropout.  Gradient accumulation
    is not ported (ROADMAP Queue 1 item 6)."""

    def step(state: TrainState, x: torch.Tensor,
             y: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        if nonfinite_guard:
            flats = state.flat_buffers()
            saved = {dtype: f.clone() for dtype, f in flats.items()}
        logits = model(x, generator)
        loss = loss_fn(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            loss = loss.detach()
            metrics = {"loss": loss, "prec1": accuracy(logits.detach(), y)}
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if clip_grad:
                scale = torch.clamp(clip_grad / (global_norm(grads) + 1e-6),
                                    max=1.0)
                torch._foreach_mul_(grads, scale)
            if nonfinite_guard:
                gnorm = global_norm(grads)
                ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            state.optimizer.step()
            if state.ema is not None:
                state.ema.update(model)
            state.step.add_(1)
            if nonfinite_guard:
                for dtype, f in flats.items():
                    torch.where(ok, f, saved[dtype], out=f)
                metrics["nonfinite"] = (~ok).float()
                metrics["gnorm"] = gnorm
        return metrics

    return step


def make_eval_step(loss_fn: Callable = cross_entropy,
                   use_ema: bool = False) -> Callable:
    """Build ``eval_step(state, x, y, valid=None) -> metrics``: ``loss`` and
    ``prec1`` over the valid samples, their ``count`` and the ``logits``,
    from the model (or its EMA) in eval mode."""

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model = state.ema.module if use_ema else state.model
        model.eval()
        with torch.inference_mode():
            logits = model(x)
            count = valid.sum() if valid is not None else \
                torch.tensor(x.shape[0], device=x.device)
            return {"loss": loss_fn(logits, y, weight=valid),
                    "prec1": accuracy(logits, y, weight=valid),
                    "count": count, "logits": logits}

    return step
