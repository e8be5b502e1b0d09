"""Samplers: the index order of an epoch.

A copy of ``deepfake_detection_tpu/data/samplers.py``.  The train sampler
draws a seeded per-epoch permutation (``SeedSequence([seed, epoch])``),
trimmed (``drop_last``) or wrap-padded to a multiple of ``num_shards ×
batch_size`` and strided per shard; the eval sampler walks the dataset in
order, wrap-pads to the same multiple and flags the padding invalid, so
metrics over it stay exact.  :func:`epoch_batches` splits one epoch into
full batches; every host loader and the device prologue read the same
``(epoch, batch_index) → indices`` mapping from it.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["ShardedTrainSampler", "OrderedShardedSampler", "epoch_batches"]


def epoch_batches(sampler, batch_size: int, valid_mask: bool = False
                  ) -> Tuple[List[List[int]], Optional[List[np.ndarray]]]:
    """``(batches, valid)`` of one epoch of ``sampler``: lists of indices
    (the trailing partial batch dropped) and, when ``valid_mask`` is set
    and the sampler reports validity, the matching bool masks."""
    indices = list(iter(sampler))
    valid = None
    if valid_mask and hasattr(sampler, "local_indices"):
        out = sampler.local_indices()
        if isinstance(out, tuple):
            indices, valid = out[0].tolist(), out[1]
    nb = len(indices) // batch_size
    batches = [indices[i * batch_size:(i + 1) * batch_size]
               for i in range(nb)]
    vms = None if valid is None else \
        [np.asarray(valid[i * batch_size:(i + 1) * batch_size])
         for i in range(nb)]
    return batches, vms


class ShardedTrainSampler:
    """Shuffling train sampler: one permutation per ``(seed, epoch)`` for
    every shard, trimmed or wrap-padded to a multiple of ``num_shards ×
    batch_size``, shard ``i`` taking every ``num_shards``-th index."""

    def __init__(self, dataset_len: int, num_shards: int = 1,
                 shard_index: int = 0, batch_size: int = 1, seed: int = 42,
                 drop_last: bool = True):
        assert 0 <= shard_index < num_shards
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        chunk = num_shards * batch_size
        if drop_last:
            self.total_size = (dataset_len // chunk) * chunk
        else:
            self.total_size = int(math.ceil(dataset_len / chunk)) * chunk
        self.num_samples = self.total_size // num_shards

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def local_indices(self) -> np.ndarray:
        perm = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch])
        ).permutation(self.dataset_len)
        if self.total_size <= self.dataset_len:
            perm = perm[:self.total_size]
        else:
            reps = int(math.ceil(self.total_size / self.dataset_len))
            perm = np.tile(perm, reps)[:self.total_size]
        return perm[self.shard_index::self.num_shards]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples


class OrderedShardedSampler:
    """Eval sampler: dataset order, wrap-padded from index 0, the padding
    flagged invalid."""

    def __init__(self, dataset_len: int, num_shards: int = 1,
                 shard_index: int = 0, batch_size: int = 1):
        assert 0 <= shard_index < num_shards
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.batch_size = batch_size
        chunk = num_shards * batch_size
        self.total_size = int(math.ceil(dataset_len / chunk)) * chunk
        self.num_samples = self.total_size // num_shards

    def set_epoch(self, epoch: int) -> None:
        pass

    def local_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, valid) of this shard."""
        idx = np.arange(self.total_size)
        valid = idx < self.dataset_len
        idx = idx % self.dataset_len
        sl = slice(self.shard_index, self.total_size, self.num_shards)
        return idx[sl], valid[sl]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices()[0].tolist())

    def __len__(self) -> int:
        return self.num_samples
