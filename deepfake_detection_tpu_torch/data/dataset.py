"""Datasets.

Only :class:`SyntheticDataset` is ported so far: a bit-for-bit copy of the
JAX package's (``deepfake_detection_tpu/data/dataset.py``), deterministic
random uint8 clips for smoke runs and benchmarks.  The real clip dataset
(``DeepFakeClipDataset``, lists, label balancing, the packed cache) is
ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["SyntheticDataset"]


class SyntheticDataset:
    """Sample ``index`` is ``(uint8 (H, W, C) image, int label)`` drawn from
    ``SeedSequence([seed, index])``."""

    def __init__(self, length: int = 64, image_shape=(600, 600, 12),
                 num_classes: int = 2, seed: int = 0,
                 transform: Optional[Callable] = None):
        self.length = length
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.seed = seed
        self.transform = transform  # accepted for interface parity; unused
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def set_transform(self, transform: Callable) -> None:
        self.transform = transform

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        g = np.random.default_rng(np.random.SeedSequence([self.seed, index]))
        img = g.integers(0, 256, self.image_shape, dtype=np.uint8)
        target = int(g.integers(0, self.num_classes))
        return img, target
