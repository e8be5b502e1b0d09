"""Checkpoints in the reference's ``.pth.tar`` layout: epoch files, the best
copy and its ``_bak`` mirror, recovery snapshots, resume.

Counterpart of ``CheckpointSaver``, ``find_resume_candidates``,
``wait_pending_saves`` and the restore functions of
``deepfake_detection_tpu/train/checkpoint.py``:

* ``checkpoint-<epoch>.pth.tar`` for the top ``max_history`` epochs by the
  eval metric, ``model_best.pth.tar`` (mirrored into ``bak_dir``) and
  ``last.pth.tar`` after every epoch;
* ``recovery-<epoch>-<batch>.pth.tar`` in-epoch snapshots, the one before
  the previous removed; written on a background thread unless ``sync``
  (the preemption path), from host copies that own their bytes: every
  tensor is copied to the CPU (a blocking copy from the card) before the
  writer thread gets it, since the train step updates the live tensors in
  place;
* :func:`find_resume_candidates` orders what ``--auto-resume`` tries, and
  a file ``torch.load`` cannot read raises :class:`CheckpointCorrupt`,
  whatever the loader raised underneath, so the caller can fall back.

Each file is one ``torch.save`` of

    {"epoch", "arch", "state_dict" (timm keys), "optimizer" (with the
     learning rate in its param groups), "state_dict_ema" (when the run
     keeps an EMA), "step", "generator" (the drop-path/dropout generator's
     state, when the run has one), "args", "metric", "version"}

plus the loop position of a recovery snapshot (``batch_idx``,
``num_updates``), with every tensor on the CPU, written to a temporary
name and renamed, so a file is whole or absent.  ``models.load_checkpoint``
reads its weights, and so does the JAX side's
``tools/convert_torch_checkpoint.convert_state_dict``.
"""

from __future__ import annotations

import glob
import logging
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from .state import TrainState

_logger = logging.getLogger(__name__)

__all__ = ["CheckpointSaver", "CheckpointCorrupt", "checkpoint_payload",
           "save_checkpoint_file", "load_checkpoint_file",
           "restore_train_state", "find_resume_candidates",
           "wait_pending_saves"]

EXT = ".pth.tar"
RECOVERY = "recovery"      # recovery snapshots: recovery-<epoch>-<batch>.pth.tar


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file exists but cannot be read (truncated write, torn
    copy, garbage).  Carries the path so that the caller can fall back to
    an older snapshot instead of crashing."""

    def __init__(self, path: str, cause: str):
        super().__init__(
            f"checkpoint {path} is corrupt or truncated ({cause}); "
            "if this was a recovery snapshot, --auto-resume falls back "
            "to the previous one automatically")
        self.path = path


def _recovery_key(path: str) -> Tuple[int, ...]:
    """(epoch, batch_idx) from ``recovery-<e>-<b>.pth.tar`` (numeric: a
    lexicographic order would put recovery-0-999 after recovery-0-1099)."""
    return tuple(int(n) for n in re.findall(r"\d+", os.path.basename(path)))


def _host(v: Any) -> Any:
    """``v`` with every tensor copied to the CPU, owning its bytes."""
    if torch.is_tensor(v):
        return v.detach().to("cpu", copy=True)
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host(x) for x in v)
    return v


def checkpoint_payload(state: TrainState, epoch: int, args: Dict[str, Any],
                       metric: Optional[float] = None,
                       meta: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """The file's contents (see the module docstring), on the host."""
    out = {"epoch": epoch, "arch": args.get("model", ""),
           "state_dict": state.model.state_dict(),
           "optimizer": state.optimizer.state_dict(),
           "step": int(state.step), "args": dict(args), "metric": metric,
           "version": 2, **(meta or {})}
    if state.ema is not None:
        out["state_dict_ema"] = state.ema.state_dict()
    if state.generator is not None:
        out["generator"] = state.generator.get_state()
    return _host(out)


# one background writer: at most one save in flight, joined before the next
_write_pool = ThreadPoolExecutor(max_workers=1,
                                 thread_name_prefix="ckpt-write")
_pending: List = []


def wait_pending_saves() -> None:
    """Block until the in-flight background write (if any) has landed.
    Async writes are recovery snapshots, best-effort by design: a failed
    one is logged against its path, not raised here."""
    while _pending:
        path, fut = _pending.pop()
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001 - best-effort snapshot
            _logger.error("async checkpoint write of %s failed: %r", path, e)


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint_file(path: str, payload: Dict[str, Any],
                         async_write: bool = False) -> None:
    """Write a host ``payload`` (:func:`checkpoint_payload`) to ``path``
    atomically; ``async_write`` hands the write to the background thread
    and returns.  Writes are ordered: a save joins the previous one
    first."""
    wait_pending_saves()
    if async_write:
        _pending.append((path, _write_pool.submit(_write, path, payload)))
    else:
        _write(path, payload)


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Read a checkpoint onto the CPU (tensors and plain containers only);
    an empty, torn or undecodable file raises :class:`CheckpointCorrupt`."""
    wait_pending_saves()
    if os.path.getsize(path) == 0:
        raise CheckpointCorrupt(path, "empty file")
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # the unpickler and zip reader raise many kinds
        raise CheckpointCorrupt(path, f"torch.load failed: {e!r}") from e
    if not isinstance(payload, dict) or "state_dict" not in payload:
        raise CheckpointCorrupt(path, "payload missing 'state_dict'")
    return payload


def restore_train_state(path: str, state: TrainState,
                        load_opt: bool = True) -> Dict[str, Any]:
    """Load ``path`` into ``state`` in place (model, EMA and, with
    ``load_opt``, the optimizer with its learning rate, the step counter
    and the generator; ``--no-resume-opt`` keeps the fresh ones) and return
    the file's other entries (``epoch``, ``batch_idx``, ...)."""
    payload = load_checkpoint_file(path)
    state.model.load_state_dict(payload["state_dict"])
    if state.ema is not None and "state_dict_ema" in payload:
        state.ema.module.load_state_dict(payload["state_dict_ema"])
    if load_opt:
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step.fill_(int(payload.get("step", 0)))
        if state.generator is not None and "generator" in payload:
            state.generator.set_state(payload["generator"])
    return {k: v for k, v in payload.items()
            if k not in ("state_dict", "state_dict_ema", "optimizer",
                         "generator")}


def find_resume_candidates(checkpoint_dir: str,
                           bak_dir: str = "") -> List[str]:
    """Paths ``--auto-resume`` tries, best first: recovery snapshots newest
    first, then the ``_bak`` best copy, then ``model_best`` itself."""
    out = sorted(glob.glob(os.path.join(checkpoint_dir,
                                        RECOVERY + "*" + EXT)),
                 key=_recovery_key, reverse=True)
    for d in (bak_dir, checkpoint_dir):
        best = os.path.join(d, "model_best" + EXT) if d else ""
        if best and os.path.isfile(best):
            out.append(best)
    return out


class CheckpointSaver:
    """Top-K epoch checkpoints by ``metric`` (lower is better when
    ``decreasing``), a best copy (and its ``bak_dir`` mirror),
    ``last.pth.tar``, and recovery snapshots."""

    def __init__(self, checkpoint_dir: str, decreasing: bool = False,
                 max_history: int = 10, bak_dir: str = ""):
        if max_history < 1:
            raise ValueError(f"max_history must be >= 1, got {max_history}")
        self.checkpoint_dir = checkpoint_dir
        self.bak_dir = bak_dir
        self.decreasing = decreasing
        self.max_history = max_history
        self.checkpoint_files: List[Tuple[str, Optional[float]]] = []
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        self.curr_recovery_file = ""
        self.last_recovery_file = ""
        for d in (checkpoint_dir, bak_dir):
            if d:
                os.makedirs(d, exist_ok=True)

    def _better(self, a: Optional[float], b: Optional[float]) -> bool:
        if a is None:
            return False
        if b is None:
            return True
        return a < b if self.decreasing else a > b

    def _mark_best(self, src: str) -> None:
        for d in (self.checkpoint_dir, self.bak_dir):
            if d:
                shutil.copyfile(src, os.path.join(d, "model_best" + EXT))

    def save_checkpoint(self, state: TrainState, args: Dict[str, Any],
                        epoch: int, metric: Optional[float] = None
                        ) -> Tuple[Optional[float], Optional[int]]:
        """Write ``last.pth.tar`` and, if ``metric`` ranks in the top
        ``max_history``, ``checkpoint-<epoch>.pth.tar`` (and the best copy).
        Returns ``(best metric, best epoch)``."""
        last = os.path.join(self.checkpoint_dir, "last" + EXT)
        save_checkpoint_file(last, checkpoint_payload(state, epoch, args,
                                                      metric))
        worst = self.checkpoint_files[-1][1] if self.checkpoint_files \
            else None
        if len(self.checkpoint_files) < self.max_history or \
                self._better(metric, worst):
            if len(self.checkpoint_files) >= self.max_history:
                path, _ = self.checkpoint_files.pop()
                if os.path.exists(path):
                    os.remove(path)
            path = os.path.join(self.checkpoint_dir,
                                f"checkpoint-{epoch}{EXT}")
            shutil.copyfile(last, path)
            self.checkpoint_files.append((path, metric))
            # best first; metric-less entries rank last
            self.checkpoint_files.sort(
                key=lambda e: (e[1] is None,
                               (e[1] if self.decreasing else -e[1])
                               if e[1] is not None else 0.0))
            if self._better(metric, self.best_metric) or \
                    self.best_epoch is None:
                self.best_metric, self.best_epoch = metric, epoch
                self._mark_best(last)
            _logger.info("checkpoints: %s", ", ".join(
                f"{os.path.basename(p)} ({m})"
                for p, m in self.checkpoint_files))
        return self.best_metric, self.best_epoch

    def save_recovery(self, state: TrainState, args: Dict[str, Any],
                      epoch: int, batch_idx: int, num_updates: int,
                      sync: bool = False) -> str:
        """In-epoch snapshot at the loop position ``(epoch, batch_idx)``
        (``num_updates``: the update count after that batch), the one
        before the previous removed.  ``sync`` blocks until the file is in
        place (the preemption path exits right after); otherwise the write
        runs in the background.  Returns the path."""
        path = os.path.join(
            self.checkpoint_dir,
            f"{RECOVERY}-{epoch}-{batch_idx}{EXT}")
        save_checkpoint_file(path, checkpoint_payload(
            state, epoch, args, meta=dict(batch_idx=batch_idx,
                                          num_updates=num_updates)),
            async_write=not sync)
        if path == self.curr_recovery_file:
            return path     # rewritten in place: a stop at a snapshot's batch
        if self.last_recovery_file and \
                os.path.exists(self.last_recovery_file):
            try:
                os.remove(self.last_recovery_file)
            except OSError as e:
                _logger.error("removing %s: %r", self.last_recovery_file, e)
        self.last_recovery_file = self.curr_recovery_file
        self.curr_recovery_file = path
        return path

    def find_recovery(self) -> str:
        """The newest recovery file, '' if none."""
        files = glob.glob(os.path.join(
            self.checkpoint_dir, RECOVERY + "*" + EXT))
        return max(files, key=_recovery_key) if files else ""
