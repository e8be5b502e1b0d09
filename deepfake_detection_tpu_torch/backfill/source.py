"""Clip sources for the backfill runner: packed mmaps or a frame tree.

The manifest names WHAT to score; a source answers HOW a clip's pixels
are obtained.  Two implementations share one contract —
``load(entry) -> (H, W, 3·frames) uint8`` with a fixed
``(frames_per_clip, sample_hw)`` geometry the runner captures its one
batch bucket against:

* :class:`PackSource` — the steady-state path: zero-decode mmap views
  over a pack (the data/packed.py layout, the JAX package's; its size
  audit runs at open so a truncated pack fails before the first batch,
  not as garbage pixels mid-corpus).  Host cost per clip is one slab
  memcpy.
* :class:`TreeSource` — the raw-tree path: frames read through the
  dataset's frame source (``data/dataset.py::load_frames``: the ``.npy``
  beside a frame when it exists, else the JPEG through the port's own
  decoder, one pool call a clip) and
  resampled to a canonical resolution (``canonical_clip_array``), for
  corpora that were never packed.  Mixed source resolutions without an
  explicit ``image_size`` are a loud error naming the clip, never a
  shape-mismatched batch.

A copy of ``deepfake_detection_tpu/backfill/source.py``.  Both tree
sources decode JPEG through a native pool: the JAX package's links
libjpeg, the port's is its own decoder (bitwise the same pixels), so a
JPEG corpus is scored on the card as it stands, with no Pillow.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.dataset import clip_frame_paths, load_frames
from ..data.packed import (PackedShardCorrupt, canonical_clip_array,
                           clip_records, load_index, open_shard_array,
                           verify_pack)
from .manifest import Entry

__all__ = ["PackSource", "TreeSource"]


class PackSource:
    """Zero-decode clip lookup over a packed cache's mmapped shards."""

    #: a load is one mmap slice view — consumers may skip thread fan-out
    #: for small clips (scheduling costs more than the memcpy)
    zero_decode = True

    def __init__(self, pack_dir: str):
        self.pack_dir = os.fspath(pack_dir)
        self.index = load_index(self.pack_dir)
        problems = verify_pack(self.pack_dir, checksums=False)
        if problems:
            raise PackedShardCorrupt("; ".join(problems))
        self.frames_per_clip = int(self.index["frames_per_clip"])
        hw = [int(v) for v in self.index["sample_hw"]]
        self.sample_hw: Tuple[int, int] = (hw[0], hw[1])
        # the shared pack-reader machinery (data/packed.py): sample
        # lookup table + size-audited lazy mmaps — one implementation
        # for PackedDataset and this source
        self._records = clip_records(self.index)
        self._mmaps: Dict[int, np.ndarray] = {}
        self._open_lock = threading.Lock()

    def _shard_array(self, si: int) -> np.ndarray:
        arr = self._mmaps.get(si)
        if arr is None:
            with self._open_lock:
                arr = self._mmaps.get(si)
                if arr is None:
                    arr = open_shard_array(self.pack_dir, self.index, si)
                    self._mmaps[si] = arr
        return arr

    def load(self, entry: Entry) -> np.ndarray:
        kind, ri, name, _num = entry
        rec = self._records.get((kind, int(ri), name))
        if rec is None:
            from .manifest import BackfillManifestStale
            raise BackfillManifestStale(
                f"{self.pack_dir}: manifest clip {kind}/{name} (root "
                f"{ri}) is not in the pack index — stale manifest")
        si, slot = rec
        return self._shard_array(si)[slot]


class TreeSource:
    """Decode-path clip lookup over v3 list-file roots."""

    def __init__(self, roots, frames_per_clip: int = 4,
                 image_size: int = 0):
        if isinstance(roots, str):
            roots = [r for r in roots.split(":") if r]
        self.roots = [os.fspath(r) for r in roots]
        self.frames_per_clip = int(frames_per_clip)
        self.image_size = int(image_size or 0)
        #: fixed once the first clip decodes (or immediately for an
        #: explicit image_size); every later clip must match it
        self.sample_hw: Optional[Tuple[int, int]] = (
            (self.image_size, self.image_size) if self.image_size else None)

    def load(self, entry: Entry) -> np.ndarray:
        kind, ri, name, num = entry
        imgs = load_frames(clip_frame_paths(
            self.roots, kind, (name, int(num), int(ri)),
            self.frames_per_clip))
        arr = canonical_clip_array(imgs, self.image_size or None)
        hw = (int(arr.shape[0]), int(arr.shape[1]))
        if self.sample_hw is None:
            self.sample_hw = hw
        elif hw != self.sample_hw:
            raise ValueError(
                f"clip {kind}/{name}: decoded {hw[1]}x{hw[0]}, the run's "
                f"batch bucket is {self.sample_hw[1]}x{self.sample_hw[0]} "
                f"— sources are mixed-resolution; set --image-size")
        return arr
