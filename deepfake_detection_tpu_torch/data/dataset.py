"""Datasets.

:class:`SyntheticDataset` and :class:`DeepFakeClipDataset` are copies of
the JAX package's (``deepfake_detection_tpu/data/dataset.py``):

* per-root ``real_list.txt`` / ``fake_list.txt`` with ``name:num_frames``
  lines (:func:`read_clip_list`);
* ``frames_per_clip`` (4) frames a clip, short clips front-padded with
  frame 0 (:func:`clip_frame_paths`);
* labels 0 = fake, 1 = real, fakes first in index space; a seeded
  train/val split (:func:`split_clips`) or ``frac``/``n`` subsetting;
  ``label_balance`` folds the fakes into as many buckets as there are
  reals, and each bucket's cursor rotates with the epoch;
* ``noise_fake`` flips a fake's label with the per-sample generator.

Frame source: frame ``i`` of a clip is ``<clip>/<i>.npy`` (uint8 HWC RGB,
read by numpy) when that file exists, else ``<clip>/<i>.jpg``, decoded by
the port's own JPEG decoder (``data/native.py``: no libjpeg, no Pillow,
bitwise libjpeg-turbo), a clip's JPEG frames in one pool call, as the JAX
package's ``_load_images`` does.  A JPEG the decoder declines (CMYK,
12-bit, arithmetic-coded, a truncated progressive stream) goes to Pillow
where Pillow imports, counted in :data:`decode_fallbacks`; without Pillow
it is a ``ValueError`` naming the file and the reason.  Any other format is
Pillow's, imported only then.  The paths the lists resolve to keep the JAX
package's ``.jpg`` names, so both packages name the same frames.

A dataset returns ``(uint8 (H, W, C) array, int label)`` once its
transform is set, and takes the per-sample ``numpy.random.Generator`` of
``SeedSequence([seed, epoch, index])``.  :class:`AugMixDataset` wraps one
and returns ``(uint8 (S, H, W, C) views, int label)``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from . import native

__all__ = ["SyntheticDataset", "DeepFakeClipDataset", "AugMixDataset",
           "read_clip_list", "clip_frame_paths", "split_clips", "read_rgb",
           "read_frame", "load_frames"]

Clip = Tuple[str, int, int]            # (name, num_frames, root_index)


_JPEG_EXTENSIONS = (".jpg", ".jpeg")

#: JPEG frames the port's decoder declined and Pillow decoded instead
decode_fallbacks = 0
_fallbacks_lock = threading.Lock()      # the loader's threads count too


def _is_jpeg_path(path) -> bool:
    return str(path).lower().endswith(_JPEG_EXTENSIONS)


def _read_pillow(img_file) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        ext = os.path.splitext(str(img_file))[1] or "(no extension)"
        raise ImportError(f"reading {ext} images needs Pillow, which is not "
                          f"installed; .npy frames need only numpy, and "
                          f"JPEG frames the port's own decoder") from e
    with Image.open(img_file) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _declined_jpeg(path, reason: Optional[str]) -> np.ndarray:
    """A JPEG the port's decoder declined: Pillow's decode where Pillow
    imports (counted), else a ValueError naming the file and why."""
    global decode_fallbacks
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    try:
        img = _read_pillow(path)
    except ImportError:
        raise ValueError(f"{path}: the port's JPEG decoder declined it "
                         f"({reason}) and Pillow, the fallback, is not "
                         f"installed") from None
    with _fallbacks_lock:
        decode_fallbacks += 1
    return img


def read_rgb(img_file) -> np.ndarray:
    """uint8 HWC RGB frame from a ``.npy`` file (numpy), a JPEG (the port's
    decoder) or any other format Pillow reads (Pillow imported only
    then)."""
    if str(img_file).endswith(".npy"):
        img = np.load(img_file, allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{img_file}: expected uint8 (H, W, 3), got "
                             f"{img.dtype} {img.shape}")
        return img
    if _is_jpeg_path(img_file):
        reasons: list = []
        img = native.decode_jpeg_file(str(img_file), reasons=reasons)
        return img if img is not None else _declined_jpeg(img_file,
                                                          reasons[0])
    return _read_pillow(img_file)


def _frame_file(path: str) -> str:
    npy = os.path.splitext(path)[0] + ".npy"
    return npy if os.path.isfile(npy) else path


def read_frame(path: str) -> np.ndarray:
    """One frame of a clip: the ``.npy`` beside ``path`` when it exists,
    else ``path`` itself."""
    return read_rgb(_frame_file(path))


def load_frames(paths: Sequence[str]) -> List[np.ndarray]:
    """A clip's frames; a path repeated by front-padding is read once, and
    the clip's JPEG frames decode together on the decoder's pool."""
    files = {p: _frame_file(p) for p in dict.fromkeys(paths)}
    jpegs = [f for f in dict.fromkeys(files.values()) if _is_jpeg_path(f)]
    decoded = {}
    if jpegs:
        reasons: list = []
        arrays = native.default_pool().decode_files(jpegs, reasons=reasons)
        for f, a, why in zip(jpegs, arrays, reasons):
            decoded[f] = a if a is not None else _declined_jpeg(f, why)
    seen = {p: decoded[f] if f in decoded else read_rgb(f)
            for p, f in files.items()}
    return [seen[p] for p in paths]


def read_clip_list(list_file: str, root_index: int = 0) -> List[Clip]:
    """``[(name, num_frames, root_index), ...]`` of one ``name:num`` list
    file; a missing file is an empty list."""
    if not os.path.isfile(list_file):
        return []
    out = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, num = line.split(":")
            out.append((name, int(num), root_index))
    return out


def clip_frame_paths(roots: Sequence[str], kind: str, clip: Clip,
                     frames_per_clip: int) -> List[str]:
    """The clip's first ``frames_per_clip`` frame paths, front-padded with
    frame 0 when the clip is shorter."""
    name, num, root_index = clip
    num = int(num)
    base = os.path.join(roots[int(root_index)], kind, name)
    k = frames_per_clip
    if num >= k:
        idxs: List[int] = list(range(k))
    else:
        idxs = [0] * (k - num) + list(range(num))
    return [os.path.join(base, f"{i}.jpg") for i in idxs]


def split_clips(clips: Sequence[Any], train_ratio: float, seed: int,
                is_training: bool) -> List[Any]:
    """Seeded split: train is ``int(len · ratio)`` clips of a seeded
    permutation, in list order; val is the rest, in list order."""
    n = len(clips)
    n_train = int(n * train_ratio)
    if n_train < 1:
        return list(clips)
    perm = np.random.default_rng(seed).permutation(n)
    train_idx = set(perm[:n_train].tolist())
    if is_training:
        return [clips[i] for i in sorted(train_idx)]
    return [clips[i] for i in range(n) if i not in train_idx]


def _array_split_buckets(items: List[Any], n_buckets: int) -> List[List[Any]]:
    """``np.array_split`` of a list into ``n_buckets`` buckets."""
    n_buckets = max(1, n_buckets)
    splits = np.array_split(np.arange(len(items)), n_buckets)
    return [[items[i] for i in idx] for idx in splits]


class DeepFakeClipDataset:
    """Clips of ``frames_per_clip`` frames in the ``name:num`` list format.

    ``roots`` is a list or a ``:``-separated string.  Subclasses swap the
    clip source through :meth:`_num_roots`, :meth:`_read_root_lists` and
    :meth:`_load_clip` (``data/packed.py``)."""

    def __init__(self, roots, frames_per_clip: int = 4,
                 transform: Optional[Callable] = None,
                 train_split: bool = False, train_ratio: float = 0.0,
                 is_training: bool = False, label_balance: bool = False,
                 noise_fake: bool = False, split_seed: int = 0,
                 frac: float = 1.0, n: Optional[int] = None):
        if isinstance(roots, str):
            roots = [r for r in roots.split(":") if r]
        self.roots = list(roots)
        self.frames_per_clip = frames_per_clip
        self.transform = transform
        self.noise_fake = noise_fake
        self.epoch = 0

        real: List[Clip] = []
        fake: List[Clip] = []
        for ri in range(self._num_roots()):
            r, f = self._read_root_lists(ri)
            real += r
            fake += f

        if train_split:
            real = split_clips(real, train_ratio, split_seed, is_training)
            fake = split_clips(fake, train_ratio, split_seed, is_training)
        else:
            rng = np.random.default_rng(split_seed)
            if 0 < frac < 1:
                if int(len(real) * frac) >= 1:
                    real = [real[i] for i in sorted(
                        rng.choice(len(real), int(len(real) * frac),
                                   replace=False))]
                if int(len(fake) * frac) >= 1:
                    fake = [fake[i] for i in sorted(
                        rng.choice(len(fake), int(len(fake) * frac),
                                   replace=False))]
            elif n:
                if len(real) > n:
                    real = [real[i] for i in sorted(
                        rng.choice(len(real), n, replace=False))]
                if len(fake) > n:
                    fake = [fake[i] for i in sorted(
                        rng.choice(len(fake), n, replace=False))]

        self.real_clips = real
        # without label_balance every fake is its own bucket; with it the
        # fakes fold into len(real) buckets, so index space is half real
        if fake:
            if label_balance and real and len(real) < len(fake):
                self.fake_buckets = _array_split_buckets(fake, len(real))
            else:
                self.fake_buckets = _array_split_buckets(fake, len(fake))
        else:
            self.fake_buckets = []

    # -- clip source hooks ----------------------------------------------
    def _num_roots(self) -> int:
        return len(self.roots)

    def _read_root_lists(self, root_index: int
                         ) -> Tuple[List[Clip], List[Clip]]:
        """(real, fake) clips of one root, in list-file order."""
        root = self.roots[root_index]
        return (read_clip_list(os.path.join(root, "real_list.txt"),
                               root_index),
                read_clip_list(os.path.join(root, "fake_list.txt"),
                               root_index))

    def _load_clip(self, kind: str, clip: Clip):
        """The clip's frames, front-padded to ``frames_per_clip``."""
        return load_frames(self._clip_paths(kind, clip))

    # -------------------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        """Move every fake bucket's cursor to ``epoch``."""
        self.epoch = epoch

    def set_transform(self, transform: Callable) -> None:
        self.transform = transform

    def __len__(self) -> int:
        return len(self.fake_buckets) + len(self.real_clips)

    def _clip_paths(self, kind: str, clip: Clip) -> List[str]:
        return clip_frame_paths(self.roots, kind, clip, self.frames_per_clip)

    def sample_clip(self, index: int, epoch: Optional[int] = None
                    ) -> Tuple[str, Clip, int]:
        """(kind, clip, label) of ``index`` at ``epoch``."""
        epoch = self.epoch if epoch is None else epoch
        if index < len(self.fake_buckets):
            bucket = self.fake_buckets[index]
            return "fake", bucket[epoch % len(bucket)], 0
        return "real", self.real_clips[index - len(self.fake_buckets)], 1

    def sample_paths(self, index: int, epoch: Optional[int] = None
                     ) -> Tuple[List[str], int]:
        """(frame paths, label) of ``index`` at ``epoch``."""
        kind, clip, target = self.sample_clip(index, epoch)
        return self._clip_paths(kind, clip), target

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        rng = rng if rng is not None else np.random.default_rng(
            np.random.SeedSequence([self.epoch, index]))
        kind, clip, target = self.sample_clip(index)
        imgs = self._load_clip(kind, clip)
        if self.transform is not None:
            imgs = self.transform(imgs, rng)
        if target == 0 and self.noise_fake:
            target = 0 if rng.random() < 0.5 else 1
        return imgs, target


class SyntheticDataset:
    """Sample ``index`` is ``(uint8 (H, W, C) image, int label)`` drawn from
    ``SeedSequence([seed, index])``; it takes no transform."""

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


class AugMixDataset:
    """Clean and AugMix views of another dataset's samples, as the JAX
    package's ``AugMixDataset``: ``num_splits`` stacked views, the base
    dataset's transformed clip first, then ``num_splits - 1`` copies with
    each frame (a 3-channel slice) augmented on its own by
    ``aug_config``'s :class:`~.auto_augment.AugMixAugment`, frames in
    order and views in order, all from the generator the base transform
    drew from.  The loader's collate stacks the views split-major."""

    def __init__(self, dataset, num_splits: int = 2,
                 aug_config: str = "augmix-m3-w3"):
        from .auto_augment import augment_and_mix_transform
        if num_splits < 2:
            raise ValueError(f"num_splits must be >= 2, got {num_splits}")
        self.dataset = dataset
        self.num_splits = num_splits
        self.augment = augment_and_mix_transform(aug_config)

    def set_transform(self, transform: Callable) -> None:
        self.dataset.set_transform(transform)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.dataset)

    def _augment_clip(self, clip: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        frames = clip.shape[-1] // 3
        out = np.empty(clip.shape[:-1] + (3 * frames,), np.uint8)
        for f in range(frames):
            out[..., 3 * f:3 * f + 3] = self.augment(
                clip[..., 3 * f:3 * f + 3], rng)
        return out

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        epoch = getattr(self.dataset, "epoch", 0)
        rng = rng if rng is not None else np.random.default_rng(
            np.random.SeedSequence([epoch, index]))
        clip, target = self.dataset.__getitem__(index, rng=rng)
        clip = np.ascontiguousarray(clip, dtype=np.uint8)
        views = [clip]
        for _ in range(self.num_splits - 1):
            views.append(self._augment_clip(clip, rng))
        return np.stack(views), target
