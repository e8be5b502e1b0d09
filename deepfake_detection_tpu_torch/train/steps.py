"""Train and eval steps.

Counterparts of ``make_train_step`` / ``make_eval_step`` in
``deepfake_detection_tpu/train/steps.py`` without a mesh: one device.  A
step is forward in train mode → loss and top-1 → backward (once a
microbatch under gradient accumulation) → gradient clipping by global
norm → optimizer step → EMA update, in place on the :class:`TrainState`.
Metrics come back as device tensors; nothing in a step reads a value back
to the host, so the host can queue the next step while the card runs this
one.

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


def _microbatches(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The JAX step's strided split: row ``j`` of microbatch ``i`` is row
    ``j·n + i`` of ``t``.  A split-major AugMix batch (each split a
    multiple of ``n`` rows) stays split-major in every microbatch.  4-D
    tensors keep channels_last memory."""
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} is not {n} microbatches")
    fmt = torch.channels_last if t.dim() == 4 else torch.contiguous_format
    return [t[i::n].contiguous(memory_format=fmt) for i in range(n)]


def make_train_step(loss_fn: Callable = cross_entropy,
                    clip_grad: Optional[float] = None,
                    nonfinite_guard: bool = False,
                    generator: Optional[torch.Generator] = None,
                    grad_accum: int = 1) -> Callable:
    """Build ``train_step(state, x, y) -> metrics``.

    ``x`` is an NCHW batch (channels_last memory), ``y`` int labels or soft
    targets.  ``metrics`` holds device scalars ``loss`` and ``prec1``, and
    with the guard ``nonfinite`` and ``gnorm`` (the clipped gradients'
    norm).  ``generator`` drives drop_path/dropout.

    ``grad_accum`` > 1 is the JAX step's gradient accumulation: the batch
    splits strided into ``grad_accum`` microbatches, each a forward and a
    backward in train mode (BN running stats carried from one to the next,
    drop-path draws continuing from ``generator``), the gradients summed
    in ``.grad`` and scaled by ``1/grad_accum``, loss and top-1 averaged;
    then one clip, one optimizer step, one EMA update and one guard
    decision, the guard's copy taken once a step."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, x: torch.Tensor,
             y: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        if nonfinite_guard:
            flats = state.flat_buffers()
            saved = {dtype: f.clone() for dtype, f in flats.items()}
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            parts = [(x, y)]
        else:
            parts = list(zip(_microbatches(x, grad_accum),
                             _microbatches(y, grad_accum)))
        loss = prec1 = None
        for xi, yi in parts:
            logits = model(xi, generator)
            li = loss_fn(logits, yi)
            li.backward()
            with torch.no_grad():
                pi = accuracy(logits.detach(), yi)
                loss = li.detach() if loss is None else loss + li.detach()
                prec1 = pi if prec1 is None else prec1 + pi
        with torch.no_grad():
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if grad_accum > 1:
                inv = 1.0 / grad_accum
                loss, prec1 = loss * inv, prec1 * inv
                torch._foreach_mul_(grads, inv)
            metrics = {"loss": loss, "prec1": prec1}
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
