"""Minimal training and eval loader.

Counterpart of the JAX package's host loader + device prologue
(``deepfake_detection_tpu/data/loader.py``), cut to what synthetic
training needs:

* samplers: train draws a seeded per-epoch permutation
  (``SeedSequence([seed, epoch])``) and drops the last partial batch; eval
  walks the dataset in order, wrap-pads the last batch and marks the
  padding invalid, so metrics stay exact;
* a host batcher thread stacks uint8 HWC samples and applies the collate
  mixup with the per-batch generator ``SeedSequence([seed, epoch, batch,
  0x77])``, as the JAX host loaders do;
* on a CUDA device each batch lands in pinned host memory and is copied
  with ``non_blocking=True``; the device normalizes with the port's own
  constants (``params.img_mean``/``img_std``, tiled per frame) and hands the
  model an NCHW view in ``channels_last`` memory.

The shm transport, device augment, RandomErasing and the packed cache are
ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..params import img_mean, img_std

__all__ = ["Loader", "train_batches", "eval_batches"]


def train_batches(n: int, batch_size: int, seed: int,
                  epoch: int) -> List[np.ndarray]:
    """Index batches of one training epoch (partial batch dropped)."""
    perm = np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)
    nb = n // batch_size
    return [perm[i * batch_size:(i + 1) * batch_size] for i in range(nb)]


def eval_batches(n: int, batch_size: int
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``(indices, valid)`` batches in order, the last wrap-padded."""
    total = int(math.ceil(n / batch_size)) * batch_size
    idx = np.arange(total)
    valid = idx < n
    idx = idx % n
    return [(idx[i:i + batch_size], valid[i:i + batch_size])
            for i in range(0, total, batch_size)]


class Loader:
    """Iterates ``(x, y)`` (train) or ``(x, y, valid)`` (eval) device
    batches; ``x`` is normalized float32 NCHW in channels_last memory, ``y``
    int64 labels or float32 soft targets (under mixup)."""

    def __init__(self, dataset, batch_size: int, is_training: bool,
                 device: torch.device, seed: int = 42,
                 collate_mixup=None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.is_training = is_training
        self.device = torch.device(device)
        self.seed = seed
        self.collate_mixup = collate_mixup if is_training else None
        self.prefetch = prefetch
        self.epoch = 0
        chans = dataset.image_shape[-1]
        reps = chans // 3
        self._mean = torch.from_numpy(np.tile(img_mean, reps)).to(self.device)
        self._std = torch.from_numpy(np.tile(img_std, reps)).to(self.device)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.is_training:
            return n // self.batch_size
        return int(math.ceil(n / self.batch_size))

    def _host_batch(self, bi: int, idx: np.ndarray):
        samples = [self.dataset[int(i)] for i in idx]
        images = np.stack([np.asarray(s[0], np.uint8) for s in samples])
        targets = np.asarray([s[1] for s in samples], np.int64)
        if self.collate_mixup is not None:
            rng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, self.epoch, bi, 0x77]))
            images, targets = self.collate_mixup(images, targets, rng)
        x = torch.from_numpy(np.ascontiguousarray(images))
        y = torch.from_numpy(np.ascontiguousarray(targets))
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        return x, y

    def _to_device(self, x: torch.Tensor, y: torch.Tensor):
        x = x.to(self.device, non_blocking=True)
        y = y.to(self.device, non_blocking=True)
        x = (x.float() - self._mean) / self._std
        return x.permute(0, 3, 1, 2), y

    def __iter__(self) -> Iterator[tuple]:
        if self.is_training:
            plan = [(b, None) for b in train_batches(
                len(self.dataset), self.batch_size, self.seed, self.epoch)]
        else:
            plan = eval_batches(len(self.dataset), self.batch_size)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for bi, (idx, _) in enumerate(plan):
                    if not put(self._host_batch(bi, idx)):
                        return
            except Exception as e:  # raised again by the consumer
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            for _, valid in plan:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                x, y = self._to_device(*item)
                if valid is None:
                    yield x, y
                else:
                    yield x, y, torch.from_numpy(valid).to(self.device)
        finally:
            stop.set()
            thread.join(timeout=5)

