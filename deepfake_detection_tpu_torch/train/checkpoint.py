"""Epoch checkpoints in the reference's ``.pth.tar`` layout.

Counterpart of ``CheckpointSaver`` in
``deepfake_detection_tpu/train/checkpoint.py``, cut to what a run needs:
``checkpoint-<epoch>.pth.tar`` for the top ``max_history`` epochs by the
eval metric, a ``model_best.pth.tar`` copy of the best, and
``last.pth.tar`` after every epoch.  Each file is one ``torch.save`` of

    {"epoch", "arch", "state_dict" (timm keys), "optimizer",
     "state_dict_ema" (when the run keeps an EMA), "args", "metric",
     "version"}

with every tensor on the CPU, written to a temporary name and renamed, so
a file is whole or absent.  ``models.load_checkpoint`` reads it back, and so
does the JAX side's ``tools/convert_torch_checkpoint.convert_state_dict``.
Recovery snapshots, the ``_bak`` copy, async saves and resume are ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from .state import TrainState

_logger = logging.getLogger(__name__)

__all__ = ["CheckpointSaver", "checkpoint_payload"]

EXT = ".pth.tar"


def _cpu(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in sd.items()}


def checkpoint_payload(state: TrainState, epoch: int, args: Dict[str, Any],
                       metric: Optional[float] = None) -> Dict[str, Any]:
    opt = state.optimizer.state_dict()
    opt["state"] = {i: _cpu(s) for i, s in opt["state"].items()}
    out = {"epoch": epoch, "arch": args.get("model", ""),
           "state_dict": _cpu(state.model.state_dict()),
           "optimizer": opt,
           "args": dict(args), "metric": metric, "version": 2}
    if state.ema is not None:
        out["state_dict_ema"] = _cpu(state.ema.state_dict())
    return out


class CheckpointSaver:
    """Top-K epoch checkpoints by ``metric`` (lower is better when
    ``decreasing``), a best copy and ``last.pth.tar``."""

    def __init__(self, checkpoint_dir: str, decreasing: bool = False,
                 max_history: int = 10):
        if max_history < 1:
            raise ValueError(f"max_history must be >= 1, got {max_history}")
        self.checkpoint_dir = checkpoint_dir
        self.decreasing = decreasing
        self.max_history = max_history
        self.checkpoint_files: List[Tuple[str, Optional[float]]] = []
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        os.makedirs(checkpoint_dir, exist_ok=True)

    def _better(self, a: Optional[float], b: Optional[float]) -> bool:
        if a is None:
            return False
        if b is None:
            return True
        return a < b if self.decreasing else a > b

    def _write(self, path: str, payload: Dict[str, Any]) -> None:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def save_checkpoint(self, state: TrainState, args: Dict[str, Any],
                        epoch: int, metric: Optional[float] = None
                        ) -> Tuple[Optional[float], Optional[int]]:
        """Write ``last.pth.tar`` and, if ``metric`` ranks in the top
        ``max_history``, ``checkpoint-<epoch>.pth.tar`` (and the best copy).
        Returns ``(best metric, best epoch)``."""
        payload = checkpoint_payload(state, epoch, args, metric)
        last = os.path.join(self.checkpoint_dir, "last" + EXT)
        self._write(last, payload)
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
                shutil.copyfile(last, os.path.join(self.checkpoint_dir,
                                                   "model_best" + EXT))
            _logger.info("checkpoints: %s", ", ".join(
                f"{os.path.basename(p)} ({m})"
                for p, m in self.checkpoint_files))
        return self.best_metric, self.best_epoch
