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

from .data.resample import resample_axis

__all__ = ["img_mean", "img_std", "image_max_height", "image_max_width",
           "img_num", "resize", "padding_image", "prepare_canvas",
           "normalize_replicate", "normalize_concat", "make_score_fn"]

img_mean = np.asarray([0.485, 0.456, 0.406], np.float32) * 255.0
img_std = np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0
image_max_height = 600
image_max_width = 600
image_max_w_h = (image_max_width, image_max_height)
img_num = 4


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
        out = resample_axis(out, width_target, 1)
    if height_target != height_o:
        out = resample_axis(out, height_target, 0)
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


def make_score_fn(model: torch.nn.Module, store=None,
                  device: Optional[torch.device] = None) -> Callable:
    """``NHWC batch → softmax scores`` (numpy or tensor in, numpy out);
    ``scores[:, 0]`` = P(fake).  The batch goes to ``device`` (default: the
    model's) as an NCHW view in channels_last memory (``permute``, no
    copy).  A quantized ``store`` (``serving/quant.py``) is realized inside
    every call, as the JAX ``make_score_fn`` realizes its tree."""
    from .serving.quant import module_forward

    if device is None:
        device = next(model.parameters()).device
    forward = module_forward(model, store)

    def score(x) -> np.ndarray:
        x = torch.as_tensor(x).permute(0, 3, 1, 2).to(device)
        with torch.inference_mode():
            return torch.softmax(forward(x), dim=-1).cpu().numpy()

    return score
