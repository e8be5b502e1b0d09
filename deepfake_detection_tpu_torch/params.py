"""Inference constants + preprocessing helpers.

Counterpart of ``deepfake_detection_tpu/params.py``: ImageNet mean/std ×255,
the 600×600 canvas and ``img_num=4``, aspect-preserving :func:`resize`,
center :func:`padding_image`, the photometric halves and the softmax score
wrapper.  Everything but :func:`make_score_fn` is numpy.

:func:`resize` needs no Pillow: it reproduces ``PIL.Image.resize(...,
BILINEAR)`` on uint8 RGB in numpy — Pillow's separable triangle filter whose
support widens with the downscale factor, coefficients in 22-bit fixed
point, and uint8 rounding after the horizontal and after the vertical pass.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["img_mean", "img_std", "image_max_height", "image_max_width",
           "img_num", "resize", "padding_image", "prepare_canvas",
           "normalize_replicate", "normalize_concat", "make_score_fn"]

img_mean = np.asarray([0.485, 0.456, 0.406], np.float32) * 255.0
img_std = np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0
image_max_height = 600
image_max_width = 600
image_max_w_h = (image_max_width, image_max_height)
img_num = 4

_PRECISION_BITS = 32 - 8 - 2      # Pillow's Resample.c fixed point


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter over the whole input: per output index the first input
    index, the tap count, and int64 fixed-point weights ``(out, ksize)``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) \
        - xmin
    ss = 1.0 / filterscale
    w = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):       # sequential sum, as the C loop adds
        arg = np.abs((x + xmin - center + 0.5) * ss)
        k = np.where((x < xmax) & (arg < 1.0), 1.0 - arg, 0.0)
        w[:, x] = k
        ww = ww + k
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, xmax, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One uint8 pass of Pillow's 8-bit resampler along ``axis``."""
    in_size = img.shape[axis]
    xmin, xmax, kk = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for x in range(kk.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        k = np.where(x < xmax, kk[:, x], 0)
        acc += src[idx] * k.reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(image: np.ndarray,
           max_w_h: Tuple[int, int] = image_max_w_h) -> np.ndarray:
    """Aspect-preserving fit to ``max_w_h`` (uint8 HWC), bilinear as Pillow
    computes it."""
    height_o, width_o = image.shape[:2]
    if float(height_o) / width_o > float(max_w_h[1]) / max_w_h[0]:
        height_target = max_w_h[1]
        width_target = int(width_o * float(height_target) / height_o)
    else:
        width_target = max_w_h[0]
        height_target = int(height_o * float(width_target) / width_o)
    out = np.asarray(image, np.uint8)
    if width_target != width_o:
        out = _resample_axis(out, width_target, 1)
    if height_target != height_o:
        out = _resample_axis(out, height_target, 0)
    return np.ascontiguousarray(out)


def padding_image(image: np.ndarray, target_h: int = image_max_height,
                  target_w: int = image_max_width) -> np.ndarray:
    """Center zero-pad to the fixed canvas."""
    height_o, width_o = image.shape[:2]
    if height_o == target_h and width_o == target_w:
        return image
    top = (target_h - height_o) // 2
    bottom = target_h - height_o - top
    left = (target_w - width_o) // 2
    right = target_w - width_o - left
    return np.pad(image, ((top, bottom), (left, right), (0, 0)),
                  "constant", constant_values=0)


def prepare_canvas(image: np.ndarray, size: int = image_max_height
                   ) -> np.ndarray:
    """Geometric half of the inference preprocess: aspect-preserving fit +
    center pad to the ``size×size`` canvas, still uint8 HWC."""
    return padding_image(resize(image, (size, size)), size, size)


def normalize_replicate(image: np.ndarray, num: int = img_num) -> np.ndarray:
    """Photometric half: uint8 HWC → normalized float32, replicated ×num to
    the model's ``3*num``-channel input."""
    image = (image.astype(np.float32) - img_mean) / img_std
    if num > 1:
        image = np.concatenate([image] * num, axis=-1)
    return image


def normalize_concat(frames, num: Optional[int] = None) -> np.ndarray:
    """Photometric half for ``num`` distinct frames: normalize each uint8 HWC
    canvas and channel-concatenate → ``(H, W, 3·num)`` float32.  Identical
    frames reproduce :func:`normalize_replicate` byte-for-byte."""
    frames = list(frames)
    if num is not None and len(frames) != num:
        raise ValueError(f"expected {num} frames, got {len(frames)}")
    if not frames:
        raise ValueError("normalize_concat needs at least one frame")
    return np.concatenate(
        [(f.astype(np.float32) - img_mean) / img_std for f in frames],
        axis=-1)


def make_score_fn(model: torch.nn.Module) -> Callable:
    """``NHWC batch → softmax scores`` (numpy or tensor in, numpy out);
    ``scores[:, 0]`` = P(fake).  The batch goes to the model's device as
    an NCHW view in channels_last memory (``permute``, no copy)."""
    device = next(model.parameters()).device

    def score(x) -> np.ndarray:
        x = torch.as_tensor(x).permute(0, 3, 1, 2).to(device)
        with torch.inference_mode():
            return torch.softmax(model(x), dim=-1).cpu().numpy()

    return score
