"""LR schedules.

A copy of the JAX package's numpy-only ``scheduler/schedules.py`` (the port
imports nothing of that package): each schedule is a pure ``lr(t)`` function
of the epoch or update index plus a thin host-side wrapper that keeps the
bookkeeping and the plateau logic.  The lr is a Python float the trainer
writes into the optimizer's param groups (``train.state.set_learning_rate``).

Dual granularity: ``step(epoch, metric)`` at epoch end,
``step_update(num_updates)`` after each optimizer update; a schedule listens
on one of the two depending on ``t_in_epochs``.  Seeded LR noise: per-t
generator seeded with ``seed + t``, normal resampled until
``|n| < noise_pct`` (or uniform in ±noise_pct), applied as ``lr · (1 + n)``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "StepSchedule", "CosineSchedule", "TanhSchedule", "PlateauSchedule",
    "Scheduler",
]


class Scheduler:
    """Base: pure ``_get_lr(t)`` + noise + epoch/update dispatch."""

    #: set True in a subclass whose ``step_update`` consumes ``metric``: the
    #: trainer then drains its buffered device metrics first so the value is
    #: fresh, at the cost of a host sync per optimizer update
    wants_update_metric: bool = False

    def __init__(self, base_lr: float, t_in_epochs: bool = True,
                 noise_range_t=None, noise_type: str = "normal",
                 noise_pct: float = 0.67, noise_std: float = 1.0,
                 noise_seed: int = 42):
        self.base_lr = float(base_lr)
        self.t_in_epochs = t_in_epochs
        self.noise_range_t = noise_range_t
        self.noise_type = noise_type
        self.noise_pct = noise_pct
        self.noise_std = noise_std
        self.noise_seed = noise_seed
        self.last_lr = float(base_lr)

    # -- override -----------------------------------------------------------
    def _get_lr(self, t: int) -> float:
        raise NotImplementedError

    # -- public API (scheduler.py:67-79) ------------------------------------
    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        """Call at epoch end with next epoch index; returns the lr to use."""
        if self.t_in_epochs:
            self.last_lr = self._add_noise(self._get_lr(epoch), epoch)
        return self.last_lr

    def step_update(self, num_updates: int,
                    metric: Optional[float] = None) -> float:
        if not self.t_in_epochs:
            self.last_lr = self._add_noise(self._get_lr(num_updates),
                                           num_updates)
        return self.last_lr

    # -- noise (scheduler.py:87-105) ----------------------------------------
    def _in_noise_range(self, t: int) -> bool:
        r = self.noise_range_t
        if r is None:
            return False
        if isinstance(r, (list, tuple)):
            return r[0] <= t < r[1]
        return t >= r

    def _add_noise(self, lr: float, t: int) -> float:
        if not self._in_noise_range(t):
            return lr
        rng = np.random.default_rng(self.noise_seed + t)
        if self.noise_type == "normal":
            while True:
                noise = float(rng.standard_normal() * self.noise_std)
                if abs(noise) < self.noise_pct:
                    break
        else:
            noise = 2 * (float(rng.random()) - 0.5) * self.noise_pct
        return lr + lr * noise

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"last_lr": self.last_lr}

    def load_state_dict(self, sd: dict) -> None:
        self.last_lr = sd.get("last_lr", self.last_lr)


def _warmup(t: int, warmup_t: int, warmup_lr_init: float,
            warmup_step: float) -> float:
    return warmup_lr_init + t * warmup_step


class StepSchedule(Scheduler):
    """Linear warmup then ``base * decay_rate ** (t // decay_t)``
    (step_lr.py:40-45).  The canonical run: decay_t=2, decay_rate=0.92."""

    def __init__(self, base_lr: float, decay_t: float, decay_rate: float = 1.0,
                 warmup_t: int = 0, warmup_lr_init: float = 0.0, **kw):
        super().__init__(base_lr, **kw)
        self.decay_t = decay_t
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_step = ((base_lr - warmup_lr_init) / warmup_t
                            if warmup_t else 1.0)
        if warmup_t:
            self.last_lr = warmup_lr_init

    def _get_lr(self, t: int) -> float:
        if t < self.warmup_t:
            return _warmup(t, self.warmup_t, self.warmup_lr_init,
                           self.warmup_step)
        return self.base_lr * (self.decay_rate ** (t // self.decay_t))


class _CyclicSchedule(Scheduler):
    """Shared restart/cycle plumbing of cosine_lr.py / tanh_lr.py."""

    def __init__(self, base_lr: float, t_initial: int, t_mul: float = 1.0,
                 lr_min: float = 0.0, decay_rate: float = 1.0,
                 warmup_t: int = 0, warmup_lr_init: float = 0.0,
                 warmup_prefix: bool = False, cycle_limit: int = 0, **kw):
        super().__init__(base_lr, **kw)
        assert t_initial > 0 and lr_min >= 0
        self.t_initial = t_initial
        self.t_mul = t_mul
        self.lr_min = lr_min
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.cycle_limit = cycle_limit
        self.warmup_step = ((base_lr - warmup_lr_init) / warmup_t
                            if warmup_t else 1.0)
        if warmup_t:
            self.last_lr = warmup_lr_init

    def _cycle(self, t: int):
        """(cycle index i, position in cycle t_curr, cycle length t_i)."""
        if self.t_mul != 1:
            i = math.floor(math.log(1 - t / self.t_initial * (1 - self.t_mul),
                                    self.t_mul))
            t_i = self.t_mul ** i * self.t_initial
            t_curr = t - (1 - self.t_mul ** i) / (1 - self.t_mul) * self.t_initial
        else:
            i = t // self.t_initial
            t_i = self.t_initial
            t_curr = t - self.t_initial * i
        return i, t_curr, t_i

    def get_cycle_length(self, cycles: int = 0) -> int:
        cycles = cycles or self.cycle_limit
        assert cycles > 0
        if self.t_mul == 1.0:
            return self.t_initial * cycles
        return int(math.floor(-self.t_initial * (self.t_mul ** cycles - 1)
                              / (1 - self.t_mul)))

    def _get_lr(self, t: int) -> float:
        if t < self.warmup_t:
            return _warmup(t, self.warmup_t, self.warmup_lr_init,
                           self.warmup_step)
        if self.warmup_prefix:
            t = t - self.warmup_t
        i, t_curr, t_i = self._cycle(t)
        if self.cycle_limit and i >= self.cycle_limit:
            return self._exhausted_lr()
        gamma = self.decay_rate ** i
        return self._cycle_lr(self.base_lr * gamma, self.lr_min * gamma,
                              t_curr / t_i)

    def _cycle_lr(self, lr_max: float, lr_min: float, frac: float) -> float:
        raise NotImplementedError

    def _exhausted_lr(self) -> float:
        return self.lr_min


class CosineSchedule(_CyclicSchedule):
    """SGDR cosine decay with restarts (cosine_lr.py:12-110)."""

    def _cycle_lr(self, lr_max, lr_min, frac):
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(math.pi * frac))


class TanhSchedule(_CyclicSchedule):
    """Hyperbolic-tangent decay (tanh_lr.py:12-115), bounds lb=-6, ub=4."""

    def __init__(self, base_lr: float, t_initial: int, lb: float = -6.0,
                 ub: float = 4.0, **kw):
        assert lb < ub
        self.lb, self.ub = lb, ub
        super().__init__(base_lr, t_initial, **kw)

    def _cycle_lr(self, lr_max, lr_min, frac):
        return lr_min + 0.5 * (lr_max - lr_min) * (
            1 - math.tanh(self.lb * (1.0 - frac) + self.ub * frac))

    def _exhausted_lr(self):
        return self.lr_min * (self.decay_rate ** self.cycle_limit)


class PlateauSchedule(Scheduler):
    """Decay when the eval metric plateaus (plateau_lr.py:6-60).

    Re-implements torch ReduceLROnPlateau semantics (mode=min, rel threshold)
    with explicit state so it checkpoints cleanly.
    """

    def __init__(self, base_lr: float, decay_rate: float = 0.1,
                 patience_t: int = 10, threshold: float = 1e-4,
                 cooldown_t: int = 0, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0, lr_min: float = 0.0,
                 mode: str = "min", **kw):
        super().__init__(base_lr, **kw)
        self.decay_rate = decay_rate
        self.patience_t = patience_t
        self.threshold = threshold
        self.cooldown_t = cooldown_t
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.lr_min = lr_min
        self.mode = mode
        self.warmup_step = ((base_lr - warmup_lr_init) / warmup_t
                            if warmup_t else 1.0)
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.current_lr = base_lr if not warmup_t else warmup_lr_init
        self.last_lr = self.current_lr

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        if epoch <= self.warmup_t and self.warmup_t:
            self.last_lr = _warmup(epoch, self.warmup_t, self.warmup_lr_init,
                                   self.warmup_step)
            return self.last_lr
        if metric is not None:
            if self._is_better(metric):
                self.best = metric
                self.num_bad = 0
            else:
                self.num_bad += 1
            # torch semantics: cooldown ticks down every epoch it is active,
            # improving or not, and bad epochs inside it don't count
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
                self.num_bad = 0
            if self.cooldown_counter == 0 and self.num_bad > self.patience_t:
                self.current_lr = max(self.current_lr * self.decay_rate,
                                      self.lr_min)
                self.cooldown_counter = self.cooldown_t
                self.num_bad = 0
        self.last_lr = self.current_lr
        return self.last_lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter,
                "current_lr": self.current_lr, "last_lr": self.last_lr}

    def load_state_dict(self, sd: dict) -> None:
        self.__dict__.update({k: v for k, v in sd.items()
                              if k in self.state_dict()})
