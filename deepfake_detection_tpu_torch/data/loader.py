"""Batch loading: host threads, then one prologue a batch on the device.

Counterpart of ``deepfake_detection_tpu/data/loader.py``:

* :class:`HostLoader`: ``--workers`` threads (a ``ThreadPoolExecutor``)
  load a batch's samples, each with its generator ``SeedSequence([seed,
  epoch, index])``, so a batch is the same for any worker count; the batch
  is stacked straight into pinned memory when the device is a card, the
  collate mixup runs with ``[seed, epoch, batch, 0x77]``, and the
  prologue's parameters are derived in the same thread, beside the batch;
  a bounded queue (``--prefetch-depth``) holds the batches ahead;
  AugMix's multi-view samples (``AugMixDataset``, ``--aug-splits``)
  collate split-major, ``[view 0 of every sample, view 1 of every sample,
  ...]`` with the targets tiled, as the JAX ``fast_collate`` stacks them;
  :meth:`DeviceLoader.fast_forward` resumes an epoch mid-way: every draw
  is keyed by the batch's absolute index, so the tail is bitwise the tail
  of a whole epoch; the ``stall_loader`` chaos point (``chaos.py``) probes
  here;
* :class:`Prologue`: on the device, on the current stream, in the host
  chain's order: warp → blur → jitter/flicker → mixup blend → cast to the
  compute dtype → normalize → erase (``data/device_augment.py``,
  ``data/random_erasing.py``), each stage that the host chain did not run
  already (under ``--resplit`` erasing leaves the first split, the clean
  views, alone); the model gets NCHW in ``channels_last`` memory;
* :class:`DeviceLoader`: copies each host batch over with ``non_blocking``
  and runs the prologue; :class:`LoaderStats` counts the consumer's wait
  for the host;
* :func:`create_deepfake_loader_v3` (the clip dataset) and
  :func:`create_loader` (datasets without a transform, as the synthetic
  one) with the JAX factory's rules, both wrapping the train set in
  ``AugMixDataset`` under ``num_aug_splits > 1`` (which excludes the
  mixup collate).

The train chain runs where the JAX factory puts it
(:func:`create_deepfake_loader_v3`): on the host by default (the JAX
package's ``--augment-device off``: ``data/transforms.py`` over
``data/imaging.py``, Pillow's bytes without Pillow), jitter and flicker
moving to the device when neither mixup nor hue asks for host order; or,
with ``augment_device``, all on the device.  The device's jitter/flicker
and erasing draw from a ``torch.Generator`` seeded a batch from
``SeedSequence([seed, epoch, batch, tag])``: a batch's draws are a
function of its position.  The JAX package draws them from ``jax.random``.

Two host transports (``loader_backend``, :data:`LOADER_BACKENDS`), as the
JAX factory's: ``thread`` (the default, :class:`HostLoader`) and ``shm``
(``data/shm_ring.py`` :class:`~.shm_ring.ShmRingLoader`: spawned worker
processes write each sample into a shared-memory ring of batch slabs; a
collector thread copies a batch out of its slab and runs the collate's
tail, :func:`finish_batch`, as the thread backend does).  Both yield the
same :class:`HostBatch` es, bitwise, and both have ``close()``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..chaos import CHAOS_ENV_VAR, chaos_from_env
from ..params import img_mean, img_std
from .dataset import AugMixDataset
from .device_augment import (DeviceAugmentSpec, apply_color_jitter,
                             derive_geometric_batch, derive_mixup_lam,
                             device_blur, device_geometric,
                             device_mixup_blend, draw_color_jitter)
from .mixup import FastCollateMixup
from .random_erasing import (EraseBox, apply_random_erasing,
                             draw_random_erasing)
from .samplers import OrderedShardedSampler, ShardedTrainSampler, \
    epoch_batches
from .shm_ring import ShmRingLoader
from .transforms_factory import (transforms_deepfake_eval_v3,
                                 transforms_deepfake_train_passthrough,
                                 transforms_deepfake_train_v3)

__all__ = ["train_batches", "eval_batches", "HostBatch", "HostLoader",
           "LoaderStats", "Prologue", "DeviceLoader", "create_loader",
           "create_deepfake_loader_v3", "batch_generator", "finish_batch",
           "LOADER_BACKENDS"]

_logger = logging.getLogger(__name__)

_JITTER_TAG = 0x6A17           # per-batch generator tags
_ERASE_TAG = 0xE2A5

LOADER_BACKENDS = ("thread", "shm")


def train_batches(n: int, batch_size: int, seed: int,
                  epoch: int) -> List[np.ndarray]:
    """Index batches of one training epoch (partial batch dropped)."""
    sampler = ShardedTrainSampler(n, batch_size=batch_size, seed=seed)
    sampler.set_epoch(epoch)
    batches, _ = epoch_batches(sampler, batch_size)
    return [np.asarray(b) for b in batches]


def eval_batches(n: int, batch_size: int
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``(indices, valid)`` batches in order, the last wrap-padded."""
    batches, vms = epoch_batches(
        OrderedShardedSampler(n, batch_size=batch_size), batch_size, True)
    return [(np.asarray(b), v) for b, v in zip(batches, vms)]


def batch_generator(seed: int, epoch: int, batch_index: int,
                    tag: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``SeedSequence([seed, epoch,
    batch_index, tag])``."""
    lo, hi = np.random.SeedSequence(
        [seed, epoch, batch_index, tag]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(lo) | (int(hi) << 32))


@dataclass
class HostBatch:
    """One collated batch on the host: its dataset ``indices``, uint8 NHWC
    ``images``, int64 labels or f32 soft ``targets``, eval's ``valid``
    mask, and the prologue's parameters (``params``)."""
    indices: List[int]
    images: torch.Tensor
    targets: torch.Tensor
    valid: Optional[torch.Tensor] = None
    params: Dict[str, Any] = field(default_factory=dict)


class LoaderStats:
    """Counters of the loaders: batches, the consumer's wait for the host
    (``host_wait_s``), the producer's load + collate time (``fetch_s``),
    the host seconds of the Prologue's enqueue (``stage_s``: the copy to
    the device and the augment chain's launches, with any wait they make)
    and the samples × host-chain stages (warp, blur, mixup blend) the
    device Prologue ran in their place (``augment_elided``)."""

    __slots__ = ("batches", "host_wait_s", "fetch_s", "stage_s",
                 "augment_elided")

    def __init__(self):
        self.batches = 0
        self.host_wait_s = 0.0
        self.fetch_s = 0.0
        self.stage_s = 0.0
        self.augment_elided = 0


class HostLoader:
    """Load, transform and collate on host threads, ahead of the consumer.

    ``prepare(bi, indices, images, epoch)``, when set (the
    :class:`DeviceLoader` sets it), runs in the producer thread after the
    collate and returns the batch's prologue parameters."""

    def __init__(self, dataset, sampler, batch_size: int, seed: int = 42,
                 num_workers: int = 1, prefetch_depth: int = 2,
                 collate_mixup: Optional[FastCollateMixup] = None,
                 valid_mask: bool = False, pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.collate_mixup = collate_mixup
        self.valid_mask = valid_mask
        self.pin_memory = pin_memory
        self.prepare: Optional[Callable] = None
        self.epoch = 0
        # mid-epoch resume: the batches before start_batch are not made;
        # the rest keep their absolute index for every per-batch draw.
        # set_epoch resets it
        self.start_batch = 0
        self.stats = LoaderStats()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.start_batch = 0
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler) // self.batch_size

    def _load_one(self, index: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, int(index)]))
        img, target = self.dataset.__getitem__(int(index), rng=rng)
        return np.asarray(img, dtype=np.uint8), target

    def _collate(self, bi: int, idx: List[int], samples, valid) -> HostBatch:
        shapes = {s[0].shape for s in samples}
        if len(shapes) > 1:
            raise ValueError(
                f"batch {bi}: samples of shapes {sorted(shapes)} cannot be "
                f"stacked; the source frames must share one size")
        first = samples[0][0]
        targets = np.asarray([s[1] for s in samples], np.int64)
        if first.ndim == 4:
            # (S, H, W, C) views a sample: split-major rows, targets tiled
            views = first.shape[0]
            images = torch.empty((views * len(samples),) + first.shape[1:],
                                 dtype=torch.uint8,
                                 pin_memory=self.pin_memory)
            arr = images.numpy().reshape((views, len(samples))
                                         + first.shape[1:])
            for b, smp in enumerate(samples):
                arr[:, b] = smp[0]
            targets = np.tile(targets, views)
        else:
            images = torch.empty((len(samples),) + first.shape,
                                 dtype=torch.uint8,
                                 pin_memory=self.pin_memory)
            np.stack([s[0] for s in samples], out=images.numpy())
        return finish_batch(self, bi, idx, images, targets, valid,
                            self.epoch)

    def __iter__(self) -> Iterator[HostBatch]:
        batches, vms = epoch_batches(self.sampler, self.batch_size,
                                     self.valid_mask)
        start = self.start_batch
        # loader points count batches within an epoch: a fresh injector an
        # epoch (none unless DFD_CHAOS is set)
        chaos = chaos_from_env() if os.environ.get(CHAOS_ENV_VAR) else None
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
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
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bi, idx in enumerate(batches):
                        if bi < start:
                            continue
                        if stop.is_set():
                            return
                        if chaos is not None and chaos.fires("stall_loader",
                                                             bi):
                            secs = chaos.arg("stall_loader", 120.0)
                            _logger.warning("chaos: stalling the loader "
                                            "%.0fs at batch %d", secs, bi)
                            time.sleep(secs)
                        t0 = time.perf_counter()
                        samples = list(pool.map(self._load_one, idx))
                        item = self._collate(
                            bi, idx, samples,
                            None if vms is None else vms[bi])
                        self.stats.fetch_s += time.perf_counter() - t0
                        self.stats.batches += 1
                        if not put(item):
                            return
                put(None)
            except Exception as e:  # raised again by the consumer
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=30)

    def close(self) -> None:
        """Nothing to release (the shm backend's ``close`` stops its
        workers)."""


def finish_batch(loader, bi: int, idx, images: torch.Tensor,
                 targets: np.ndarray, valid, epoch: int) -> HostBatch:
    """The collate's tail, shared by both host transports: the collate
    mixup (``[seed, epoch, bi, 0x77]``) blended into ``images`` in place,
    the :class:`HostBatch`, the prologue's parameters (``loader.prepare``)
    and the pinned targets and valid mask."""
    if loader.collate_mixup is not None:
        mrng = np.random.default_rng(np.random.SeedSequence(
            [loader.seed, epoch, bi, 0x77]))
        arr = images.numpy()
        mixed, targets = loader.collate_mixup(arr, targets, mrng)
        if mixed is not arr:
            arr[...] = mixed
    batch = HostBatch(list(idx), images,
                      torch.from_numpy(np.ascontiguousarray(targets)))
    if valid is not None:
        batch.valid = torch.from_numpy(np.asarray(valid))
    if loader.prepare is not None:
        batch.params = loader.prepare(bi, batch.indices, images, epoch)
    if loader.pin_memory:
        batch.targets = batch.targets.pin_memory()
        if batch.valid is not None:
            batch.valid = batch.valid.pin_memory()
    return batch


class Prologue:
    """The device side of a batch, stage by stage (each stage is a method,
    so a benchmark can time it alone), in the compute ``dtype``."""

    def __init__(self, device, img_num: int = 4,
                 spec: Optional[DeviceAugmentSpec] = None,
                 dtype: torch.dtype = torch.float32):
        self.img_num = img_num
        self.spec = spec
        self.dtype = dtype
        # ImageNet's mean and std ×255, tiled to every frame.  f32: the JAX
        # DeviceLoader's compiled prologue divides by the constant std as a
        # multiply by its f32 reciprocal, and so does this one.  bf16: it
        # rounds x, mean and std to bf16 (0.485·255 = 123.675 becomes
        # 123.5) and rounds the difference before the true division, as XLA
        # compiles it on the CPU (bitwise, tests/test_torch_amp.py)
        mean = torch.from_numpy(np.tile(img_mean, img_num)).to(device)
        std = torch.from_numpy(np.tile(img_std, img_num)).to(device)
        self.mean = mean.to(dtype)
        self.std = std.to(dtype)
        self.inv_std = torch.from_numpy(
            np.float32(1.0) / np.tile(img_std, img_num)).to(device)

    def warp(self, images: torch.Tensor, coeffs: torch.Tensor):
        return device_geometric(images, coeffs, self.spec.size)

    def blur(self, x: torch.Tensor, frames: List[Tuple[int, int]]):
        return device_blur(x, frames, self.spec.blur_radius)

    def jitter(self, x: torch.Tensor, params: Dict[str, torch.Tensor]):
        return apply_color_jitter(x, params, self.img_num)

    def blend(self, x: torch.Tensor, lam: Tuple[np.float32, np.float32]):
        return device_mixup_blend(x, lam[0], lam[1], self.spec.mixup_blocks)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return (x.to(torch.float32) - self.mean) * self.inv_std
        return (x.to(self.dtype) - self.mean) / self.std

    def erase(self, x: torch.Tensor, boxes: List[EraseBox]):
        return apply_random_erasing(x, boxes, self.img_num)

    def __call__(self, images: torch.Tensor,
                 params: Dict[str, Any]) -> torch.Tensor:
        """uint8 NHWC ``images`` on the device → normalized NCHW in the
        compute dtype, ``channels_last`` memory."""
        x = images
        if "coeffs" in params:
            x = self.warp(x, params["coeffs"])
            x = self.blur(x, params.get("blur", []))
        if "jitter" in params:
            x = self.jitter(x.to(torch.float32), params["jitter"])
        if "lam" in params:
            x = self.blend(x, params["lam"])
        x = self.normalize(x)
        if params.get("erase"):
            x = self.erase(x, params["erase"])
        return x.permute(0, 3, 1, 2)


class DeviceLoader:
    """Iterates ``(x, y)`` (train) or ``(x, y, valid)`` (eval) on the
    device: the host batch goes over with ``non_blocking`` and through the
    :class:`Prologue`."""

    def __init__(self, host: HostLoader, device, prologue: Prologue,
                 color_jitter=None, flicker: float = 0.0,
                 erasing: Optional[Dict[str, Any]] = None):
        self.loader = host
        self.device = torch.device(device)
        self.prologue = prologue
        self.color_jitter = color_jitter
        self.flicker = flicker
        self.erasing = erasing
        self.stats = LoaderStats()
        host.prepare = self.prepare

    @property
    def mixup_enabled(self) -> bool:
        """Whether the collate mixup blends (``--mixup-off-epoch`` turns it
        off, as the JAX loader's property)."""
        cm = self.loader.collate_mixup
        return bool(cm is not None and cm.mixup_enabled)

    @mixup_enabled.setter
    def mixup_enabled(self, on: bool) -> None:
        if self.loader.collate_mixup is not None:
            self.loader.collate_mixup.mixup_enabled = on

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def close(self) -> None:
        """Release the host loader's workers and shared memory (the shm
        backend; a no-op for threads)."""
        self.loader.close()

    def fast_forward(self, start_batch: int) -> None:
        """Resume mid-epoch: the next iteration yields the batches from
        ``start_batch`` on, bitwise the tail of a whole epoch (the samples,
        the mixup and the prologue's draws are keyed by the absolute batch
        index).  Call after :meth:`set_epoch`; the next one clears it."""
        self.loader.start_batch = max(0, int(start_batch))

    def __len__(self) -> int:
        return len(self.loader)

    def prepare(self, bi: int, indices: List[int], images: torch.Tensor,
                epoch: int) -> Dict[str, Any]:
        """The prologue's parameters of batch ``bi`` (host thread)."""
        spec = self.prologue.spec
        seed = self.loader.seed
        b, h, w, c = images.shape
        params: Dict[str, Any] = {}
        if spec is not None:
            coeffs, blur = derive_geometric_batch(spec, indices, seed, epoch,
                                                  (h, w))
            params["coeffs"] = torch.from_numpy(coeffs)
            params["blur"] = [tuple(v) for v in np.argwhere(blur).tolist()]
            h, w = spec.size
            if spec.mixup:
                cm = self.loader.collate_mixup
                params["lam"] = derive_mixup_lam(
                    seed, epoch, bi, spec.mixup_alpha,
                    bool(cm is not None and cm.mixup_enabled))
        if self.color_jitter is not None or self.flicker > 0.0:
            params["jitter"] = draw_color_jitter(
                batch_generator(seed, epoch, bi, _JITTER_TAG), b,
                self.prologue.img_num, self.color_jitter, self.flicker)
        if self.erasing is not None:
            params["erase"] = draw_random_erasing(
                batch_generator(seed, epoch, bi, _ERASE_TAG), b, h, w, c,
                img_num=self.prologue.img_num, **self.erasing)
        return params

    def to_device(self, batch: HostBatch) -> HostBatch:
        """The batch and its tensor parameters on the device."""
        dev = self.device
        pin = dev.type == "cuda"

        def move(t):
            if t is None or t.device == dev:
                return t
            return (t.pin_memory() if pin and not t.is_pinned()
                    else t).to(dev, non_blocking=True)

        params = dict(batch.params)
        if "coeffs" in params:
            params["coeffs"] = move(params["coeffs"])
        if "erase" in params:
            params["erase"] = [bx._replace(fill=move(bx.fill))
                               for bx in params["erase"]]
        return HostBatch(batch.indices, move(batch.images),
                         move(batch.targets), move(batch.valid), params)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            self.stats.host_wait_s += t1 - t0
            self.stats.batches += 1
            p = batch.params
            self.stats.augment_elided += len(batch.indices) * (
                ("coeffs" in p) + bool(p.get("blur")) + ("lam" in p))
            batch = self.to_device(batch)
            x = self.prologue(batch.images, batch.params)
            self.stats.stage_s += time.perf_counter() - t1
            if batch.valid is None:
                yield x, batch.targets
            else:
                yield x, batch.targets, batch.valid


def _build_loader(dataset, transform, batch_size: int, is_training: bool,
                  device, collate_mixup, seed: int, num_workers: int,
                  prefetch_depth: int, img_num: int,
                  spec: Optional[DeviceAugmentSpec], color_jitter, flicker,
                  erasing, dtype: torch.dtype,
                  num_aug_splits: int = 0, loader_backend: str = "thread",
                  ring_depth: int = 4,
                  worker_heartbeat: float = 120.0) -> DeviceLoader:
    """Shared tail of the factories: the AugMix wrap, transform, sampler,
    host transport (``loader_backend``), prologue."""
    if loader_backend not in LOADER_BACKENDS:
        raise ValueError(f"loader_backend must be one of {LOADER_BACKENDS}, "
                         f"got {loader_backend!r}")
    if is_training and num_aug_splits > 1:
        # clean + (num_aug_splits - 1) AugMix views a sample, for the JSD
        # loss; the views are rows of one batch, which a mixup would blend
        if collate_mixup is not None:
            raise ValueError("aug_splits and the mixup collate are mutually "
                             "exclusive")
        dataset = AugMixDataset(dataset, num_splits=num_aug_splits)
    if transform is not None:
        dataset.set_transform(transform)
    if is_training:
        sampler: Any = ShardedTrainSampler(len(dataset), batch_size=batch_size,
                                           seed=seed, drop_last=True)
    else:
        sampler = OrderedShardedSampler(len(dataset), batch_size=batch_size)
    device = torch.device(device)
    kw = dict(seed=seed, num_workers=num_workers,
              prefetch_depth=prefetch_depth,
              collate_mixup=collate_mixup if is_training else None,
              valid_mask=not is_training, pin_memory=device.type == "cuda")
    if loader_backend == "shm":
        host: Any = ShmRingLoader(dataset, sampler, batch_size,
                                  ring_depth=ring_depth,
                                  heartbeat_timeout=worker_heartbeat, **kw)
    else:
        host = HostLoader(dataset, sampler, batch_size, **kw)
    prologue = Prologue(device, img_num, spec, dtype)
    return DeviceLoader(host, device, prologue,
                        color_jitter if is_training else None,
                        flicker if is_training else 0.0,
                        erasing if is_training else None)


def _erasing(re_prob, re_mode, re_count, re_split, re_max,
             num_aug_splits: int = 0):
    """RandomErasing's arguments; under ``re_split`` the first of
    ``num_aug_splits or 2`` splits (the clean one) is not erased."""
    if re_prob <= 0.0:
        return None
    return dict(probability=re_prob, max_area=re_max, mode=re_mode,
                max_count=re_count,
                num_splits=(num_aug_splits or 2) if re_split else 0)


def create_loader(dataset, batch_size: int, is_training: bool, device,
                  img_num: int = 1, re_prob: float = 0.0,
                  re_mode: str = "const", re_count: int = 1,
                  re_split: bool = False, re_max: float = 0.02,
                  num_workers: int = 1,
                  collate_mixup: Optional[FastCollateMixup] = None,
                  seed: int = 42, prefetch_depth: int = 2,
                  dtype: torch.dtype = torch.float32,
                  num_aug_splits: int = 0, loader_backend: str = "thread",
                  ring_depth: int = 4,
                  worker_heartbeat: float = 120.0) -> DeviceLoader:
    """A loader for a dataset that takes no transform (the synthetic one):
    the AugMix views, collate, the host mixup blend, normalize and erase,
    in ``dtype``; the host transport ``loader_backend`` (``thread`` or
    ``shm``, with its ``ring_depth`` and ``worker_heartbeat``)."""
    return _build_loader(
        dataset, None, batch_size, is_training, device, collate_mixup, seed,
        num_workers, prefetch_depth, img_num, None, None, 0.0,
        _erasing(re_prob, re_mode, re_count, re_split, re_max,
                 num_aug_splits), dtype, num_aug_splits, loader_backend,
        ring_depth, worker_heartbeat)


def create_deepfake_loader_v3(
        dataset, input_size, batch_size: int, is_training: bool = False,
        device="cuda", re_prob: float = 0.0, re_mode: str = "const",
        re_count: int = 1, re_split: bool = False, re_max: float = 0.02,
        color_jitter: Any = 0.4, num_workers: int = 1,
        collate_mixup: Optional[FastCollateMixup] = None,
        flicker: float = 0.0, rotate_range: float = 0,
        blur_radius: Optional[float] = None, blur_prob: float = 0.0,
        seed: int = 42, prefetch_depth: int = 2, eval_crop: str = "random",
        device_color_jitter: bool = True, fused_geom: bool = True,
        augment_device: bool = False,
        dtype: torch.dtype = torch.float32,
        num_aug_splits: int = 0, loader_backend: str = "thread",
        ring_depth: int = 4,
        worker_heartbeat: float = 120.0) -> DeviceLoader:
    """The clip dataset's loader, ``input_size`` ``(C, H, W)``, batches in
    the compute ``dtype``, the host side on ``loader_backend``'s transport
    (train and eval alike); where each train stage runs follows the JAX
    factory's decisions one for one:

    * ``augment_device``: the passthrough on the host, the whole chain on
      the device (jitter as three values, or one for all three; the collate
      mixup draws ``lam`` and the targets only, ``blend=False``); it
      conflicts with ``fused_geom=False`` and with host jitter/flicker
      (``device_color_jitter=False``), and falls back to the host chain for
      hue jitter;
    * otherwise the host chain (``transforms_deepfake_train_v3``: the warp,
      or the sequential geometry when ``fused_geom`` is False, and the
      blur), with jitter and flicker on the device when
      ``device_color_jitter`` and neither hue jitter nor mixup (which
      jitters each source clip before the blend) keeps them on the host;
      the mixup blend in the host collate;
    * ``num_aug_splits > 1``: ``num_aug_splits`` views a sample
      (``AugMixDataset`` over the host chain's output; no mixup), the
      whole chain on the host (``augment_device`` falls back to it, with a
      log line: AugMix augments the warped clip) and the jitter and flicker
      too (the views of a sample share one draw), erasing off the clean
      split under ``re_split``.

    Eval: a random or centre crop on the host, normalize on the device."""
    c, h, w = input_size
    img_num = max(1, c // 3)
    size = (h, w)
    img_size = h if h == w else size
    transport = dict(loader_backend=loader_backend, ring_depth=ring_depth,
                     worker_heartbeat=worker_heartbeat)
    if not is_training:
        return _build_loader(
            dataset, transforms_deepfake_eval_v3(img_size, crop=eval_crop),
            batch_size, False, device, None, seed, num_workers,
            prefetch_depth, img_num, None, None, 0.0, None, dtype,
            **transport)
    aug_device = bool(augment_device)
    if aug_device and num_aug_splits > 1:
        # AugMix augments the clip after the host chain's warp; a device
        # warp would come after it instead
        _logger.info("aug-splits active: device augmentation falls back "
                     "to the host chain")
        aug_device = False
    if aug_device and not fused_geom:
        raise ValueError("augment_device renders the fused geometric warp "
                         "on device; it conflicts with the host_geom / "
                         "fused_geom=False parity escape hatch — pick one")
    device_cj = None
    device_flicker = 0.0
    if device_color_jitter:
        cj = None
        if color_jitter is not None:
            cj = (tuple(color_jitter)
                  if isinstance(color_jitter, (list, tuple))
                  else (float(color_jitter),) * 3)
            assert len(cj) in (3, 4)
        if cj is not None and len(cj) == 4 and float(cj[3]) > 0:
            # hue jitter runs on the host only (no HSV round trip on the
            # device): the whole chain stays there
            _logger.info("hue jitter requested: color jitter stays on host")
            aug_device = False
        elif aug_device or (collate_mixup is None and num_aug_splits <= 1):
            device_cj = tuple(float(v) for v in cj[:3]) if cj else None
            device_flicker, flicker = flicker, 0.0
            color_jitter = None
        elif collate_mixup is not None:
            # the host chain jitters each source clip before the mixup
            # blends two of them; a jitter after the blend would correlate
            # the two sources' photometrics
            _logger.info("mixup active: color jitter stays on host")
        else:
            # a sample's views share the base chain's one jitter draw; as
            # rows of the batch they would each draw their own on the
            # device
            _logger.info("aug-splits active: color jitter stays on host")
    if aug_device and (color_jitter is not None or flicker > 0.0):
        raise ValueError(
            "augment_device leaves no host transform stage for host-side "
            "color jitter/flicker — drop host_color_jitter (hue jitter "
            "already falls back to the host chain automatically)")
    spec = None
    if aug_device:
        spec = DeviceAugmentSpec(
            size=size, rotate_range=int(rotate_range),
            blur_prob=float(blur_prob),
            blur_radius=float(blur_radius or 0.0), img_num=img_num,
            mixup=collate_mixup is not None,
            mixup_alpha=getattr(collate_mixup, "mixup_alpha", 0.0))
        if collate_mixup is not None:
            collate_mixup.blend = False
        transform = transforms_deepfake_train_passthrough(
            img_size, rotate_range=rotate_range, blur_prob=blur_prob)
    else:
        transform = transforms_deepfake_train_v3(
            img_size, color_jitter=color_jitter, flicker=flicker,
            rotate_range=rotate_range, blur_radius=blur_radius,
            blur_prob=blur_prob, fused_geom=fused_geom)
    return _build_loader(
        dataset, transform, batch_size, True, device, collate_mixup, seed,
        num_workers, prefetch_depth, img_num, spec, device_cj,
        device_flicker,
        _erasing(re_prob, re_mode, re_count, re_split, re_max,
                 num_aug_splits), dtype, num_aug_splits, **transport)
