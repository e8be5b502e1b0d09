"""Schedule factory (a copy of the JAX package's numpy-only one).

Maps ``--sched step|cosine|tanh|plateau`` to a schedule and returns
``(schedule, num_epochs)``; cosine and tanh extend ``num_epochs`` by the
cycle length plus cooldown.  ``--lr-noise`` fractions of the total epochs
become absolute noise-range thresholds.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .schedules import (CosineSchedule, PlateauSchedule, Scheduler,
                        StepSchedule, TanhSchedule)

__all__ = ["create_scheduler"]


def create_scheduler(cfg, base_lr: Optional[float] = None
                     ) -> Tuple[Optional[Scheduler], int]:
    num_epochs = cfg.epochs
    lr = base_lr if base_lr is not None else cfg.lr
    assert lr is not None

    noise_range = None
    if getattr(cfg, "lr_noise", None) is not None:
        n = cfg.lr_noise
        if isinstance(n, (list, tuple)):
            noise_range = [x * num_epochs for x in n]
            if len(noise_range) == 1:
                noise_range = noise_range[0]
        else:
            noise_range = n * num_epochs

    noise_kw = dict(noise_range_t=noise_range,
                    noise_pct=getattr(cfg, "lr_noise_pct", 0.67),
                    noise_std=getattr(cfg, "lr_noise_std", 1.0),
                    noise_seed=getattr(cfg, "seed", 42))

    sched = None
    if cfg.sched == "cosine":
        sched = CosineSchedule(
            lr, t_initial=num_epochs, t_mul=1.0, lr_min=cfg.min_lr,
            decay_rate=cfg.decay_rate, warmup_lr_init=cfg.warmup_lr,
            warmup_t=cfg.warmup_epochs, cycle_limit=1, **noise_kw)
        num_epochs = sched.get_cycle_length() + cfg.cooldown_epochs
    elif cfg.sched == "tanh":
        sched = TanhSchedule(
            lr, t_initial=num_epochs, t_mul=1.0, lr_min=cfg.min_lr,
            warmup_lr_init=cfg.warmup_lr, warmup_t=cfg.warmup_epochs,
            cycle_limit=1, **noise_kw)
        num_epochs = sched.get_cycle_length() + cfg.cooldown_epochs
    elif cfg.sched == "step":
        sched = StepSchedule(
            lr, decay_t=cfg.decay_epochs, decay_rate=cfg.decay_rate,
            warmup_lr_init=cfg.warmup_lr, warmup_t=cfg.warmup_epochs,
            **noise_kw)
    elif cfg.sched == "plateau":
        sched = PlateauSchedule(
            lr, decay_rate=cfg.decay_rate, patience_t=cfg.patience_epochs,
            lr_min=cfg.min_lr, warmup_lr_init=cfg.warmup_lr,
            warmup_t=cfg.warmup_epochs, cooldown_t=cfg.cooldown_epochs)
    return sched, num_epochs
