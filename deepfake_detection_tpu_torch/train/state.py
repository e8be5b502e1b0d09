"""Train state: what a train step mutates, in one object.

Counterpart of ``deepfake_detection_tpu/train/state.py``.  Where the JAX
package threads an immutable pytree through a donated jitted step, the port
updates the model, optimizer and EMA in place; ``step`` is a device counter
that only a finite step advances.  ``generator``, when the run has one, is
the drop-path/dropout generator the train step draws from (the JAX runner
keys its draws by ``fold_in(rng, num_updates)``); checkpoints carry its
state, so that a resumed run draws what the uninterrupted one would.

:meth:`TrainState.flat_buffers` re-homes every tensor a step changes into
one flat buffer per dtype (each parameter, buffer, moment and EMA tensor
becomes a view of it, with its own strides), so the non-finite guard can
snapshot and restore the whole state with one kernel per dtype.  Every
update of the state is in place, so the views stay views.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn

from ..utils.ema import ModelEma

__all__ = ["TrainState", "create_train_state", "set_learning_rate",
           "get_learning_rate"]


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[ModelEma] = None
    step: torch.Tensor = field(default=None)
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        if self.step is None:
            device = next(self.model.parameters()).device
            self.step = torch.zeros((), dtype=torch.int64, device=device)

    def _slots(self) -> Iterator[Tuple[torch.Tensor, Callable]]:
        """``(tensor, rebind)`` for every tensor a train step changes, in a
        fixed order: parameters, buffers (BN running stats), optimizer
        state, EMA, the counter."""
        def param(p):
            def rebind(t):
                p.data = t
            return p.data, rebind

        def buffers(module):
            for mod in module.modules():
                for name, b in mod._buffers.items():
                    if b is not None:
                        yield b, functools.partial(mod._buffers.__setitem__,
                                                   name)
        for p in self.model.parameters():
            yield param(p)
        yield from buffers(self.model)
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                st = self.optimizer.state[p]
                for k, v in st.items():
                    if torch.is_tensor(v):
                        yield v, functools.partial(st.__setitem__, k)
        if self.ema is not None:
            for p in self.ema.module.parameters():
                yield param(p)
            yield from buffers(self.ema.module)
        yield self.step, functools.partial(setattr, self, "step")

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a train step changes (see :meth:`_slots`)."""
        return [t for t, _ in self._slots()]

    def flat_buffers(self) -> Dict[torch.dtype, torch.Tensor]:
        """One flat buffer per dtype whose views are :meth:`tensors`;
        (re)built when a tensor is not a view of them (first call, or after
        something replaced a tensor)."""
        flats = getattr(self, "_flats", None)
        slots = list(self._slots())
        if flats is not None and all(
                t.untyped_storage().data_ptr()
                == flats[t.dtype].untyped_storage().data_ptr()
                for t, _ in slots):
            return flats
        sizes: Dict[torch.dtype, int] = {}
        for t, _ in slots:
            sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
        flats = {dtype: torch.empty(n, dtype=dtype, device=self.step.device)
                 for dtype, n in sizes.items()}
        offset = dict.fromkeys(sizes, 0)
        for t, rebind in slots:
            view = flats[t.dtype].as_strided(t.shape, t.stride(),
                                             offset[t.dtype])
            view.copy_(t)
            rebind(view)
            offset[t.dtype] += t.numel()
        self._flats = flats
        return flats


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       with_ema: bool = False, ema_decay: float = 0.9998,
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    return TrainState(model, optimizer,
                      ModelEma(model, ema_decay) if with_ema else None,
                      generator=generator)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Write ``lr`` into every param group (the scheduler's rewrite)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def get_learning_rate(state: TrainState) -> Optional[float]:
    groups = state.optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None
