"""Host transforms over a clip's frames, with an explicit generator.

The part of ``deepfake_detection_tpu/data/transforms.py`` that the port's
pipeline runs, on uint8 ``(H, W, 3)`` arrays (no Pillow):

* train (``--augment-device on``): :class:`DeviceAugmentPassthrough`
  consumes the rng draws of the fused geometric chain
  (:func:`fused_geometric_params`, a copy with the same float64
  arithmetic) and of the per-frame blur coins (:func:`blur_mask_draws`),
  and hands the raw ``(H, W, 3F)`` clip on; the device prologue re-derives
  the same draws from ``(seed, epoch, index)`` and renders them
  (``data/device_augment.py``);
* eval: :class:`MultiRandomCrop` (the reference evaluates on a random
  crop) or :class:`MultiCenterCrop`, each padding to the crop first,
  centred, with zeros (:func:`_pad_to_np`), then :class:`MultiConcate`.

Every transform is called as ``t(frames, rng)``; :class:`Compose`
threads the generator through.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np

__all__ = ["Compose", "PackedFrames", "RandomCrop", "MultiRandomCrop",
           "MultiCenterCrop", "MultiConcate", "DeviceAugmentPassthrough",
           "fused_geometric_params", "blur_mask_draws"]


class Compose:
    """Chains transforms, threading the generator through each."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img, rng: np.random.Generator):
        for t in self.transforms:
            img = t(img, rng)
        return img

    def __repr__(self):
        return f"Compose({self.transforms!r})"


class PackedFrames(list):
    """Frame views into one ``(H, W, 3·F)`` uint8 buffer (a packed-cache
    sample), so the passthrough can hand the buffer on without a copy."""

    def __init__(self, views, base: np.ndarray):
        super().__init__(views)
        self.base = base


def _wh(img: np.ndarray) -> Tuple[int, int]:
    return img.shape[1], img.shape[0]


def _pad_to_np(a: np.ndarray, tw: int, th: int, fill=0) -> np.ndarray:
    """Pad to at least ``th × tw``, the frame centred (offsets floor of
    half the margin), ``fill`` around it."""
    h, w = a.shape[:2]
    if w >= tw and h >= th:
        return a
    nw, nh = max(w, tw), max(h, th)
    out = np.full((nh, nw) + a.shape[2:], fill, np.uint8)
    out[(nh - h) // 2:(nh - h) // 2 + h,
        (nw - w) // 2:(nw - w) // 2 + w] = a
    return out


class RandomCrop:
    """A random ``size`` window's draw (:meth:`get_params`)."""

    def __init__(self, size: Union[int, Tuple[int, int]],
                 pad_if_needed: bool = False, fill: int = 0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.pad_if_needed = pad_if_needed
        self.fill = fill

    def get_params(self, img: np.ndarray,
                   rng: np.random.Generator) -> Tuple[int, int]:
        th, tw = self.size
        w, h = _wh(img)
        top = int(rng.integers(0, h - th + 1)) if h > th else 0
        left = int(rng.integers(0, w - tw + 1)) if w > tw else 0
        return top, left


class MultiRandomCrop(RandomCrop):
    """One crop window shared by all frames of the clip."""

    def __call__(self, imgs, rng: np.random.Generator):
        if self.pad_if_needed:
            imgs = [_pad_to_np(a, self.size[1], self.size[0], self.fill)
                    for a in imgs]
        top, left = self.get_params(imgs[0], rng)
        th, tw = self.size
        return [a[top:top + th, left:left + tw] for a in imgs]


class MultiCenterCrop:
    """Centre crop of every frame after :func:`_pad_to_np` (``--eval-crop
    center``); draws nothing."""

    def __init__(self, size, fill: int = 0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.fill = fill

    def __call__(self, imgs, rng=None):
        th, tw = self.size
        out = []
        for a in imgs:
            a = _pad_to_np(a, tw, th, self.fill)
            w, h = _wh(a)
            left = int(round((w - tw) / 2.0))
            top = int(round((h - th) / 2.0))
            out.append(a[top:top + th, left:left + tw])
        return out


class MultiConcate:
    """Frames → one ``(H, W, 3·F)`` array on the channel axis."""

    def __call__(self, imgs, rng=None) -> np.ndarray:
        return np.concatenate(imgs, axis=-1)


def _rot_canvas(w: int, h: int, deg: float) -> Tuple[int, int]:
    """Canvas size of Pillow's ``rotate(deg, expand=True)``, computed as
    Pillow computes it (the centre offset inside the ceil/floor; exact
    sizes at right angles)."""
    deg_n = deg % 360
    if deg_n in (0, 180):
        return w, h
    if deg_n in (90, 270):
        return h, w
    a = -math.radians(deg)
    # Pillow rounds to 15 decimals, so near-axis angles give exact 0/±1
    c, s = round(math.cos(a), 15), round(math.sin(a), 15)
    cx, cy = w / 2.0, h / 2.0
    m2 = cx - (c * cx + s * cy)
    m5 = cy - (-s * cx + c * cy)
    xs, ys = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        xs.append(c * x + s * y + m2)
        ys.append(-s * x + c * y + m5)
    nw = int(math.ceil(max(xs)) - math.floor(min(xs)))
    nh = int(math.ceil(max(ys)) - math.floor(min(ys)))
    return nw, nh


def fused_geometric_params(w: int, h: int, size: Tuple[int, int],
                           rotate_range: int, scale: Tuple[float, float],
                           p_flip: float, rng: np.random.Generator
                           ) -> Tuple[float, float, float,
                                      float, float, float]:
    """Draw rotate (expand) → hflip → random resize → pad-if-needed →
    random crop, in that chain's order (angle, coin, scale, top, left), and
    compose the output → source index-space affine ``(A, B, C, D, E, F)``:
    ``x_src = A·x + B·y + C``, ``y_src = D·x + E·y + F``."""
    th, tw = size
    deg = (int(rng.integers(-rotate_range, rotate_range + 1))
           if rotate_range else 0)
    flip = rng.random() < p_flip
    s = rng.uniform(scale[0], scale[1])
    w1, h1 = _rot_canvas(w, h, deg) if deg else (w, h)
    w2, h2 = int(w1 * s), int(h1 * s)          # the resize's rounding
    ww, hh = max(w2, tw), max(h2, th)          # the pad_if_needed canvas
    px, py = (ww - w2) // 2, (hh - h2) // 2    # centre pad offsets
    top = int(rng.integers(0, hh - th + 1)) if hh > th else 0
    left = int(rng.integers(0, ww - tw + 1)) if ww > tw else 0

    # composed right to left: crop/pad shift → inverse resize → inverse
    # flip → inverse rotate; the half-pixel centre terms fold into C and F
    a = math.radians(deg)
    cos, sin = math.cos(a), math.sin(a)
    sx, sy = w1 / w2, h1 / h2
    ax, bx = sx, 0.0
    cx = (left - px + 0.5) * sx - 0.5
    dy, ey = 0.0, sy
    fy = (top - py + 0.5) * sy - 0.5
    if flip:
        ax, bx, cx = -ax, -bx, (w1 - 1) - cx
    cos, sin = round(cos, 15), round(sin, 15)
    A = cos * ax - sin * dy
    B = cos * bx - sin * ey
    C = (cos * (cx - w1 / 2 + 0.5) - sin * (fy - h1 / 2 + 0.5)
         + w / 2 - 0.5)
    D = sin * ax + cos * dy
    E = sin * bx + cos * ey
    F = (sin * (cx - w1 / 2 + 0.5) + cos * (fy - h1 / 2 + 0.5)
         + h / 2 - 0.5)
    return (A, B, C, D, E, F)


def blur_mask_draws(n: int, p: float, rng: np.random.Generator) -> List[bool]:
    """One blur coin per frame, frame-major."""
    return [rng.random() < p for _ in range(n)]


class DeviceAugmentPassthrough:
    """Host half of the device augment chain: consume the geometric and
    blur draws, return the raw ``(H, W, 3F)`` clip.

    Consuming exactly the draws of the host chain keeps every later draw
    of the sample (``noise_fake``) where the host chain would find it.  The
    device warp needs one source shape per batch, so a clip of mixed frame
    shapes raises."""

    def __init__(self, size, rotate_range: float = 0,
                 scale=(2.0 / 3, 3.0 / 2.0), p_flip: float = 0.5,
                 blur_prob: float = 0.0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.rotate_range = int(rotate_range)
        self.scale = scale
        self.p_flip = p_flip
        self.blur_prob = blur_prob

    def __call__(self, imgs, rng: np.random.Generator) -> np.ndarray:
        w, h = _wh(imgs[0])
        fused_geometric_params(w, h, self.size, self.rotate_range,
                               self.scale, self.p_flip, rng)
        if self.blur_prob > 0.0:
            blur_mask_draws(len(imgs), self.blur_prob, rng)
        if isinstance(imgs, PackedFrames):
            return imgs.base
        if len({a.shape for a in imgs}) > 1:
            raise ValueError(
                "the device augment chain needs one source frame shape "
                f"(one warp per batch); got {[a.shape for a in imgs]} "
                "within one clip: pre-size the frames or pack the tree "
                "(data/packed.py)")
        return np.concatenate(imgs, axis=-1)
