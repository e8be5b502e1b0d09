"""Epoch-level training and validation loops.

Counterparts of ``train_one_epoch`` and ``validate`` in
``deepfake_detection_tpu/train/trainer.py``, with its resilience hooks,
chaos points, telemetry and on-demand profiler.  The train step returns
device scalars; the loop buffers them and reads them back only at the log
interval and at the last batch, so the host keeps queueing steps while the
card works.  A buffered step whose loss or
guard flag is not finite is counted and logged, and its loss stays out of
the average.

With a ``resilience`` (``train/resilience.py``) the loop feeds the stall
watchdog a beat a step, hands each drained step to the anomaly guard
(which raises ``RewindRequested`` after K bad steps in a row), and stops at
a step boundary after SIGTERM/SIGINT: a synchronous recovery snapshot,
then ``Preempted``.  With ``cfg.recovery_interval`` it writes a recovery
snapshot every that many batches and at the epoch's last one.  The
``DFD_CHAOS`` points ``nanbatch`` (a NaN batch), ``truncate_ckpt`` (tear
the newest snapshot) and ``sigterm`` (signal itself) count optimizer
updates.

With a ``telemetry`` (``obs/telemetry.py``) the loop hands it each step's
host seconds and, at each drain, how long the read-back blocked: the
window's data / device / host breakdown and the MFU gauge, with no read
of a device tensor added.  Its ``profiler`` (``obs/profiler.py``) gets a
window check a step and a trigger-file check a drain.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.metrics import AverageMeter, auc
from .checkpoint import wait_pending_saves
from .resilience import Preempted
from .state import TrainState, get_learning_rate, set_learning_rate

_logger = logging.getLogger(__name__)

__all__ = ["train_one_epoch", "validate"]


def train_one_epoch(epoch: int, train_step: Callable, state: TrainState,
                    loader, cfg, lr_scheduler=None, saver=None,
                    args: Optional[Dict[str, Any]] = None,
                    start_batch: int = 0, resilience=None, telemetry=None):
    """One epoch over ``loader``; returns ``(state, metrics)`` with the
    epoch's average ``loss`` and ``prec1``, the ``learning_rate``, the count
    of ``nonfinite`` steps and the host seconds of each step
    (``step_s``; a step's time includes the read-back of buffered metrics
    at its drain, so it is the device's time at ``--log-interval 1``).

    ``start_batch`` > 0 resumes mid-epoch: the caller has fast-forwarded
    the loader to it, and the loop continues the absolute batch index and
    update count.  ``saver`` (a ``CheckpointSaver``) and ``args`` (the
    run's config dict) are what recovery snapshots need.  From epoch
    ``cfg.mixup_off_epoch`` on (when set) the loader's mixup is off."""
    off = getattr(cfg, "mixup_off_epoch", 0)
    if getattr(cfg, "mixup", 0) > 0 and hasattr(loader, "mixup_enabled") \
            and off and epoch >= off:
        loader.mixup_enabled = False
    batch_time_m, data_time_m = AverageMeter(), AverageMeter()
    losses_m, prec1_m = AverageMeter(), AverageMeter()
    num_batches = len(loader)
    last_idx = num_batches - 1
    num_updates = epoch * num_batches + start_batch
    nonfinite_total = 0
    lr = get_learning_rate(state)
    pending: List = []
    step_s: List[float] = []
    chaos = getattr(resilience, "chaos", None)
    if chaos is not None and not chaos.active:
        chaos = None
    recovery_interval = getattr(cfg, "recovery_interval", 0)
    # telemetry window: how long drains blocked (device-bound time) and how
    # many drained steps were bad, since the last record
    drain_wait_acc = 0.0
    drain_bad_acc = 0
    profiler = getattr(telemetry, "profiler", None)

    def save_recovery(batch_idx: int, sync: bool = False) -> None:
        if saver is not None:
            saver.save_recovery(state, args or {}, epoch, batch_idx,
                                num_updates, sync=sync)

    def drain() -> None:
        nonlocal nonfinite_total, drain_wait_acc, drain_bad_acc
        t_drain = time.perf_counter()
        for m, n, step_i in pending:
            loss_value = float(m["loss"])
            bad = not np.isfinite(loss_value)
            if "nonfinite" in m:
                bad = bad or float(m["nonfinite"]) > 0
            if bad:
                nonfinite_total += 1
                drain_bad_acc += 1
                _logger.warning(
                    "non-finite training step at update %d (loss %r%s)",
                    step_i, loss_value,
                    "; update skipped" if "nonfinite" in m else
                    "; UPDATE APPLIED (guard off)")
            else:
                losses_m.update(loss_value, n)
            prec1_m.update(float(m["prec1"]), n)
            if resilience is not None:
                # raises RewindRequested after K consecutive bad steps
                resilience.observe_step(step_i, loss_value, bad)
        pending.clear()
        # the reads above are the loop's only synchronizing calls, so their
        # block time IS the device-bound share of the window
        drain_wait_acc += time.perf_counter() - t_drain

    end = time.perf_counter()
    for batch_idx, batch in enumerate(loader, start=start_batch):
        x, y = batch[0], batch[1]
        last_batch = batch_idx == last_idx
        data_time_m.update(time.perf_counter() - end)
        if chaos is not None and chaos.fires("nanbatch", num_updates):
            _logger.warning("chaos: poisoning batch at update %d",
                            num_updates)
            x = torch.full_like(x, float("nan"))
        metrics = train_step(state, x, y)
        bs = x.shape[0]
        pending.append((metrics, bs, num_updates))
        num_updates += 1
        log_now = last_batch or batch_idx % cfg.log_interval == 0
        if log_now:
            drain()
        batch_time_m.update(time.perf_counter() - end)
        step_s.append(batch_time_m.val)
        if telemetry is not None:
            # host floats the loop already holds: no device access
            telemetry.on_step(bs, data_time_m.val, batch_time_m.val)
        if profiler is not None:
            profiler.on_step(num_updates, metrics.get("loss"))
        if log_now:
            lr = get_learning_rate(state) or 0.0
            _logger.info(
                "Train:%d [%4d/%d] Loss:%.5f(%.5f) Prec@1:%7.4f(%7.4f) "
                "Time:%.3f(%.3f)s/batch %.5f(%.5f)s/image LR:%.3e "
                "Data:%.3f(%.3f)s/batch",
                epoch, batch_idx, num_batches, losses_m.val, losses_m.avg,
                prec1_m.val, prec1_m.avg, batch_time_m.val,
                batch_time_m.avg, batch_time_m.val / bs,
                batch_time_m.avg / bs, lr, data_time_m.val,
                data_time_m.avg)
            if telemetry is not None:
                telemetry.on_drain(
                    epoch=epoch, batch_idx=batch_idx,
                    num_updates=num_updates, loss=losses_m.avg,
                    prec1=prec1_m.avg, lr=lr, drain_wait_s=drain_wait_acc,
                    nonfinite_steps=drain_bad_acc)
                drain_wait_acc, drain_bad_acc = 0.0, 0
            if profiler is not None:
                profiler.poll()         # PROFILE trigger file: 1 stat a drain
        if recovery_interval and (
                last_batch or (batch_idx + 1) % recovery_interval == 0):
            save_recovery(batch_idx)
            if telemetry is not None:
                telemetry.inc("recovery_snapshots_total")
        if chaos is not None and saver is not None and \
                chaos.fires("truncate_ckpt", num_updates):
            _chaos_truncate(saver.curr_recovery_file or saver.find_recovery())
        if lr_scheduler is not None:
            new_lr = lr_scheduler.step_update(num_updates=num_updates)
            if new_lr is not None and new_lr != lr:
                set_learning_rate(state, new_lr)
        if resilience is not None:
            resilience.heartbeat(f"epoch {epoch} batch {batch_idx}/"
                                 f"{num_batches} update {num_updates}")
            if chaos is not None and chaos.fires("sigterm", num_updates):
                _logger.warning("chaos: delivering SIGTERM to self at "
                                "update %d", num_updates)
                os.kill(os.getpid(), signal.SIGTERM)
            if resilience.sync_verdicts():
                # the state after this step, on disk before the exit
                drain()
                save_recovery(batch_idx, sync=True)
                if telemetry is not None:
                    telemetry.inc("recovery_snapshots_total")
                raise Preempted(epoch, batch_idx, resilience.stop_signum)
        end = time.perf_counter()
    return state, OrderedDict([("loss", losses_m.avg),
                               ("prec1", prec1_m.avg),
                               ("learning_rate", lr),
                               ("nonfinite", nonfinite_total),
                               ("step_s", step_s)])


def _chaos_truncate(path: str) -> None:
    """Chaos point: tear the newest recovery file in half, as a crash in
    the middle of a copy would (exercises ``--auto-resume``'s fallback)."""
    wait_pending_saves()            # the background write must have landed
    if not path or not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))
    _logger.warning("chaos: truncated checkpoint %s (%d -> %d bytes)",
                    path, size, max(size // 2, 1))


def validate(eval_step: Callable, state: TrainState, loader, cfg,
             log_suffix: str = "", resilience=None
             ) -> "OrderedDict[str, float]":
    """Full pass over the eval loader, exact thanks to its validity mask;
    returns the average ``loss`` and ``prec1`` over valid samples and, for
    a two-class model, ``auc``: P(real) (labels are 0 = fake, 1 = real)
    ranked over the valid rows of the whole epoch, the scores kept on the
    device and read back once after the loop.  ``resilience`` keeps the
    stall watchdog fed (an eval batch is a beat)."""
    batch_time_m = AverageMeter()
    losses_m, prec1_m = AverageMeter(), AverageMeter()
    all_scores, all_labels, all_valid = [], [], []
    num_batches = len(loader)
    log_name = "Test" + log_suffix
    end = time.perf_counter()
    for batch_idx, batch in enumerate(loader):
        x, y = batch[0], batch[1]
        valid = batch[2] if len(batch) > 2 else None
        metrics = eval_step(state, x, y, valid)
        n = float(metrics["count"])
        if n > 0:
            losses_m.update(float(metrics["loss"]), n)
            prec1_m.update(float(metrics["prec1"]), n)
        logits = metrics.get("logits")
        if logits is not None and logits.shape[-1] == 2:
            all_scores.append(torch.softmax(logits, dim=-1)[:, 1].float())
            all_labels.append(y.reshape(-1))
            all_valid.append(torch.ones_like(all_scores[-1])
                             if valid is None else valid.reshape(-1))
        batch_time_m.update(time.perf_counter() - end)
        if resilience is not None:
            resilience.heartbeat(f"eval batch {batch_idx}/{num_batches}")
        if batch_idx == num_batches - 1 or batch_idx % cfg.log_interval == 0:
            _logger.info("%s: [%4d/%d] Time:%.3f(%.3f) Loss:%.4f(%.4f) "
                         "Prec@1:%7.4f(%7.4f)", log_name, batch_idx,
                         num_batches, batch_time_m.val, batch_time_m.avg,
                         losses_m.val, losses_m.avg, prec1_m.val,
                         prec1_m.avg)
        end = time.perf_counter()
    out = OrderedDict([("loss", losses_m.avg), ("prec1", prec1_m.avg)])
    if all_scores:
        out["auc"] = auc(torch.cat(all_scores), torch.cat(all_labels),
                         torch.cat(all_valid))
        _logger.info("%s: AUC %.5f", log_name, out["auc"])
    return out
