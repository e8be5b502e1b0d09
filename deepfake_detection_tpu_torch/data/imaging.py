"""Pillow's image ops of the train augment chain, without Pillow.

The JAX package's host chain (``data/transforms.py`` there) calls Pillow
12: ``ImageEnhance.Brightness``/``Contrast``/``Color``, a hue step through
``convert("HSV")``, ``ImageFilter.GaussianBlur``, and for its sequential
geometry ``rotate(expand=True)``, ``FLIP_LEFT_RIGHT`` and a bilinear
``resize``.  The card's machine has no Pillow, so each op here computes
Pillow's bytes itself, on uint8 ``(H, W, 3)`` arrays:

* the per-pixel ops, the blur and the NEAREST rotation run in
  ``native/imaging.cc`` (built by ``data/native.py``; a library that cannot
  be built raises, nothing falls back), outside the interpreter lock;
* the flip is an array view reversed along the width; the resize is
  ``data/resample.py``'s Pillow-exact resampler, width first.

A frame may be a channel slice of a packed ``(H, W, 3F)`` clip: the native
ops read it in place (pixel stride ``3F``, dense rows); every op returns a
new tight array.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np

from . import native
from .resample import resample_axis

__all__ = ["luma", "rgb_to_hsv", "hsv_to_rgb", "brightness", "contrast",
           "color", "hue", "grey_mean", "gaussian_blur", "rotate",
           "flip_left_right", "resize_bilinear"]

_FIXED_LIMIT = 32768.0            # Pillow's 16.16 affine walk's range


def _src(a: np.ndarray) -> Tuple[np.ndarray, int]:
    """``(array, pixel stride)`` of an RGB frame for the library."""
    a = np.asarray(a)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) frame, got "
                         f"{a.dtype} {a.shape}")
    return native._stage_warp_src(a)


def _pixel_op(name: str, a: np.ndarray, *args, channels: int = 3
              ) -> np.ndarray:
    src, ss = _src(a)
    h, w = src.shape[:2]
    out = np.empty((h, w, channels) if channels > 1 else (h, w), np.uint8)
    getattr(native.library(), name)(
        src.ctypes.data, ss, out.ctypes.data, h * w, *args)
    return out


def luma(a: np.ndarray) -> np.ndarray:
    """``convert("L")``: ``(19595 R + 38470 G + 7471 B + 2¹⁵) >> 16``."""
    return _pixel_op("dfd_img_luma", a, channels=1)


def rgb_to_hsv(a: np.ndarray) -> np.ndarray:
    """``convert("HSV")`` (Pillow's f32/f64 arithmetic, truncated)."""
    return _pixel_op("dfd_img_rgb_to_hsv", a)


def hsv_to_rgb(a: np.ndarray) -> np.ndarray:
    """An ``HSV`` image's ``convert("RGB")``."""
    return _pixel_op("dfd_img_hsv_to_rgb", a)


def brightness(a: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(factor)``."""
    return _pixel_op("dfd_img_brightness", a, float(factor))


def grey_mean(a: np.ndarray) -> int:
    """``int(ImageStat.Stat(img.convert("L")).mean[0] + 0.5)``."""
    src, ss = _src(a)
    return int(native.library().dfd_img_grey_mean(
        src.ctypes.data, ss, src.shape[0] * src.shape[1]))


def contrast(a: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(factor)``: the blend with the
    frame's rounded grey mean."""
    return _pixel_op("dfd_img_contrast", a, float(factor))


def color(a: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(factor)``: the blend with the
    frame's ``L`` widened to RGB."""
    return _pixel_op("dfd_img_color", a, float(factor))


def hue(a: np.ndarray, h: float) -> np.ndarray:
    """The JAX ``ColorJitter``'s hue step: ``convert("HSV")``, the hue
    plus ``int(h * 255)`` modulo 256, ``convert("RGB")``."""
    return _pixel_op("dfd_img_hue", a, int(h * 255))


def gaussian_blur(a: np.ndarray, radius: float) -> np.ndarray:
    """``img.filter(ImageFilter.GaussianBlur(radius))``: three extended box
    passes along the rows, then three along the columns."""
    src, ss = _src(a)
    h, w = src.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    native.library().dfd_img_gaussian_blur(
        src.ctypes.data, w, h, ss, out.ctypes.data, float(radius))
    return out


def _affine(matrix, x: float, y: float) -> Tuple[float, float]:
    a, b, c, d, e, f = matrix
    return a * x + b * y + c, d * x + e * y + f


def rotate(a: np.ndarray, deg: int) -> np.ndarray:
    """``img.rotate(deg, expand=True)`` (NEAREST, black outside), with
    Pillow's exact-size transposes at multiples of 90° and its canvas and
    matrix arithmetic otherwise."""
    a = np.asarray(a)
    angle = deg % 360.0
    if angle == 0:
        return a.copy()
    if angle == 180:
        return np.ascontiguousarray(a[::-1, ::-1])
    if angle == 90:
        return np.ascontiguousarray(np.rot90(a, 1))
    if angle == 270:
        return np.ascontiguousarray(np.rot90(a, -1))
    h, w = a.shape[:2]
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2], m[5] = _affine(m, -cx - 0, -cy - 0)
    m[2] += cx
    m[5] += cy
    xs, ys = zip(*(_affine(m, x, y)
                   for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
    nw = math.ceil(max(xs)) - math.floor(min(xs))
    nh = math.ceil(max(ys)) - math.floor(min(ys))
    m[2], m[5] = _affine(m, -(nw - w) / 2.0, -(nh - h) / 2.0)
    if m[1] == 0 and m[3] == 0:
        raise ValueError(f"rotate({deg}): a pure scaling matrix, which "
                         f"Pillow renders by another path")
    if not all(abs(v) < _FIXED_LIMIT for x, y in (
            (0, 0), (nw, nh), (0, nh), (nw, 0)) for v in _affine(m, x, y)):
        raise ValueError(f"rotate({deg}) of a {w}×{h} frame: a canvas "
                         f"beyond Pillow's 16.16 fixed-point walk")
    src, ss = _src(a)
    out = np.empty((nh, nw, 3), np.uint8)
    native.library().dfd_img_affine_nearest(
        src.ctypes.data, w, h, ss, out.ctypes.data, nw, nh,
        (ctypes.c_double * 6)(*m))
    return out


def flip_left_right(a: np.ndarray) -> np.ndarray:
    """``img.transpose(FLIP_LEFT_RIGHT)`` (a reversed view)."""
    return np.asarray(a)[:, ::-1]


def resize_bilinear(a: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``img.resize((tw, th), BILINEAR)``: the width pass, then the
    height pass, each only where that extent changes."""
    tw, th = int(size[0]), int(size[1])
    out = np.asarray(a, np.uint8)
    if tw != out.shape[1]:
        out = resample_axis(out, tw, 1)
    if th != out.shape[0]:
        out = resample_axis(out, th, 0)
    return np.ascontiguousarray(out)
