"""Pillow's 8-bit bilinear resampler in numpy, one axis at a time.

``PIL.Image.resize(..., BILINEAR)`` on uint8 RGB: a separable triangle
filter whose support widens with the downscale factor, coefficients in
22-bit fixed point, and uint8 rounding after each pass.  numpy and the
standard library only, so the pack writer (``data/packed.py``) and the
backfill manifest that reads packs import no torch; :func:`..params.resize`
runs the two passes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resample_axis"]

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


def resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
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
