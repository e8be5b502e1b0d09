"""The train augment chain on the device, as torch ops.

Counterpart of ``deepfake_detection_tpu/data/device_augment.py`` (the JAX
package's ``--augment-device on``).  The loader's prologue runs, in the
host chain's order: warp → blur → colour jitter / flicker → mixup blend;
then normalize and erase (``data/loader.py``, ``data/random_erasing.py``).
Every stage works on an NHWC float32 batch of integer-valued pixels in
0..255 until normalize.

Where the parameters come from:

* warp and blur: the per-sample numpy stream ``SeedSequence([seed, epoch,
  index])``, the same draws the host passthrough consumes
  (:func:`derive_geometric_batch`, ``data/transforms.py``);
* the mixup lambda: the per-batch stream ``[seed, epoch, batch, 0x77]`` of
  the collate (:func:`derive_mixup_lam`);
* jitter and flicker: :func:`draw_color_jitter` on an explicit
  ``torch.Generator`` (the JAX package draws them from ``jax.random``,
  which torch cannot reproduce; the loader seeds one generator a batch from
  ``SeedSequence([seed, epoch, batch, tag])``).

All parameters are derived on the host beside the batch; the device ops
read them as Python numbers or as small tensors, with no read-back.

Numerics (held by ``tests/test_torch_device_augment.py``):

* warp: bilinear gather in f32, taps outside the source read 0, rounded
  half to even onto the integer grid.  Integer coefficients (no rotation,
  scale 1) are bit-exact against the JAX package; at fractional ones the
  source coordinate ``A·x + B·y + C`` may be fused into an FMA by one side
  and not the other, and one ulp can flip a rounding at .5: a grey level;
* blur: separable Gaussian, sigma = radius, 3σ support, edges clamped,
  rounded; only frames whose coin fired are blurred;
* mixup: bit-exact against the host blend, because each scalar is split
  into two halves of at most 12 mantissa bits, so every product with an
  8-bit pixel is exact whatever FMA contraction does;
* jitter: brightness ``x·b``, contrast ``m + c·(x − m)`` about the frame's
  mean luma, saturation ``gray + s·(x − gray)`` (ITU-R 601-2 luma), in a
  random order, each clamped to [0, 255]; flicker zeroes whole frames.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .transforms import blur_mask_draws, fused_geometric_params

__all__ = ["DeviceAugmentSpec", "derive_geometric_batch", "derive_mixup_lam",
           "device_geometric", "gaussian_taps", "device_blur", "split_f32",
           "device_mixup_blend", "draw_color_jitter", "apply_color_jitter"]

_LUMA = (0.299, 0.587, 0.114)          # Pillow's convert("L"), ITU-R 601-2


@dataclasses.dataclass(frozen=True)
class DeviceAugmentSpec:
    """The train chain's static settings.  ``mixup_blocks`` is the number
    of per-process sub-batches the mixup flip stays within."""
    size: Tuple[int, int]                # (th, tw) output crop
    rotate_range: int = 0
    scale: Tuple[float, float] = (2.0 / 3, 3.0 / 2.0)
    p_flip: float = 0.5
    blur_prob: float = 0.0
    blur_radius: float = 1.0
    img_num: int = 4
    mixup: bool = False
    mixup_alpha: float = 0.0
    mixup_blocks: int = 1


def derive_geometric_batch(spec: DeviceAugmentSpec, indices, seed: int,
                           epoch: int, src_hw: Tuple[int, int]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(coeffs (B, 6) f32, blur mask (B, F) bool) of one batch: each
    sample's ``fused_geometric_params`` and ``blur_mask_draws`` from its
    ``(seed, epoch, index)`` generator."""
    h, w = src_hw
    coeffs = np.empty((len(indices), 6), np.float32)
    blur = np.zeros((len(indices), spec.img_num), bool)
    for i, idx in enumerate(indices):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, epoch, int(idx)]))
        coeffs[i] = fused_geometric_params(
            w, h, spec.size, spec.rotate_range, spec.scale, spec.p_flip,
            rng)
        if spec.blur_prob > 0.0:
            blur[i] = blur_mask_draws(spec.img_num, spec.blur_prob, rng)
    return coeffs, blur


def derive_mixup_lam(seed: int, epoch: int, batch_index: int, alpha: float,
                     enabled: bool) -> Tuple[np.float32, np.float32]:
    """(lam, 1 − lam) of the collate's per-batch stream; ``1 − lam`` is
    formed in float64 before the f32 cast, as numpy's host blend does."""
    lam = 1.0
    if enabled:
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed, epoch, batch_index, 0x77]))
        lam = float(rng.beta(alpha, alpha))
    return np.float32(lam), np.float32(1.0 - lam)


def device_geometric(x: torch.Tensor, coeffs: torch.Tensor,
                     size: Tuple[int, int]) -> torch.Tensor:
    """uint8 ``(B, Hs, Ws, C)`` and f32 ``coeffs (B, 6)`` on one device →
    f32 ``(B, th, tw, C)``: one bilinear gather an output pixel, zero
    outside the source, rounded."""
    b, hs, ws, c = x.shape
    th, tw = size
    dev = x.device
    yy = torch.arange(th, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(tw, dtype=torch.float32, device=dev)[None, :]
    k = coeffs.to(torch.float32)[:, :, None, None]          # (B, 6, 1, 1)
    sx = k[:, 0] * xx + k[:, 1] * yy + k[:, 2]              # (B, th, tw)
    sy = k[:, 3] * xx + k[:, 4] * yy + k[:, 5]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = x.reshape(b, hs * ws, c)
    rows = torch.arange(b, device=dev)[:, None]

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < hs) & (xi >= 0) & (xi < ws)
        idx = yi.clamp(0, hs - 1) * ws + xi.clamp(0, ws - 1)
        v = flat[rows, idx.reshape(b, -1)].reshape(b, th, tw, c)
        return torch.where(inb[..., None], v.to(torch.float32), 0.0)

    out = (tap(y0i, x0i) * ((1 - fx) * (1 - fy))[..., None]
           + tap(y0i, x0i + 1) * (fx * (1 - fy))[..., None]
           + tap(y0i + 1, x0i) * ((1 - fx) * fy)[..., None]
           + tap(y0i + 1, x0i + 1) * (fx * fy)[..., None])
    return torch.round(out)


def gaussian_taps(radius: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps, sigma = radius, support 3σ."""
    sigma = max(float(radius), 1e-3)
    r = max(1, int(math.ceil(3.0 * sigma)))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, taps: Sequence[float], dim: int
               ) -> torch.Tensor:
    n = x.shape[dim]
    r = (len(taps) - 1) // 2
    src = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    xp = x.index_select(dim, src)                 # clamp-to-edge padding
    acc = taps[0] * xp.narrow(dim, 0, n)
    for i in range(1, len(taps)):
        acc = acc + taps[i] * xp.narrow(dim, i, n)
    return acc


def device_blur(x: torch.Tensor, frames: Sequence[Tuple[int, int]],
                radius: float) -> torch.Tensor:
    """Blur frames ``(sample, frame)`` of f32 ``x (B, H, W, 3F)`` in place
    (H, then W; rounded); the other frames are untouched."""
    if not frames:
        return x
    taps = [float(t) for t in gaussian_taps(radius)]
    sel = torch.stack([x[b, :, :, 3 * f:3 * f + 3] for b, f in frames])
    blurred = torch.round(_blur_axis(_blur_axis(sel, taps, 1), taps, 2))
    for i, (b, f) in enumerate(frames):
        x[b, :, :, 3 * f:3 * f + 3] = blurred[i]
    return x


def split_f32(c) -> Tuple[float, float]:
    """An f32 scalar as (high, low): the high half keeps the top 12
    mantissa bits (an int32 bit view with the low 12 bits cleared), the low
    half is the exact remainder."""
    c = np.float32(c)
    hi = (np.asarray(c).view(np.int32) & np.int32(~0xFFF)).view(np.float32)
    return float(hi), float(np.float32(c - hi))


def device_mixup_blend(x: torch.Tensor, lam, one_minus_lam,
                       blocks: int = 1) -> torch.Tensor:
    """The collate's uint8 blend ``RN(RN(x·lam) + RN(rev·(1 − lam)))`` on
    integer-valued f32 ``x (B, ...)``, bit-exact; ``rev`` flips the batch
    within each of ``blocks`` sub-batches."""
    if blocks > 1:
        shp = x.shape
        rev = torch.flip(x.reshape((blocks, shp[0] // blocks) + shp[1:]),
                         dims=(1,)).reshape(shp)
    else:
        rev = torch.flip(x, dims=(0,))
    lh, ll = split_f32(lam)
    oh, ol = split_f32(one_minus_lam)
    p1 = x * lh + x * ll                  # == RN(x·lam): exact products
    p2 = rev * oh + rev * ol              # == RN(rev·(1 − lam))
    return torch.round(p1 + p2)


def draw_color_jitter(generator: torch.Generator, batch: int, img_num: int,
                      color_jitter: Optional[Sequence[float]],
                      flicker: float) -> Dict[str, torch.Tensor]:
    """One clip's jitter draw a sample (brightness, contrast and saturation
    factors, uniform in [max(0, 1 − j), 1 + j]; a random order of the three
    ops) and one flicker coin a frame, on ``generator``'s device."""
    params: Dict[str, torch.Tensor] = {}
    jit = color_jitter is not None and any(color_jitter)
    if jit:
        for name, j in zip("bcs", color_jitter):
            lo, hi = max(0.0, 1 - j), 1 + j
            u = torch.rand(batch, generator=generator,
                           device=generator.device)
            params[name] = lo + (hi - lo) * u
        params["order"] = torch.argsort(torch.rand(
            batch, 3, generator=generator, device=generator.device), dim=1)
    if flicker > 0.0:
        params["drop"] = torch.rand(batch, img_num, generator=generator,
                                    device=generator.device) < flicker
    return params


def apply_color_jitter(x: torch.Tensor, params: Dict[str, torch.Tensor],
                       img_num: int) -> torch.Tensor:
    """Jitter then flicker f32 ``x (B, H, W, 3·img_num)`` in place with
    host-side ``params`` (of :func:`draw_color_jitter`)."""
    b, h, w, _ = x.shape
    if "order" in params:
        luma = torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
        order = params["order"].tolist()
        bs, cs, ss = (params[k].tolist() for k in "bcs")
        for i in range(b):
            fr = x[i].reshape(h, w, img_num, 3)
            for op in order[i]:
                if op == 0:                                   # brightness
                    fr = fr * bs[i]
                elif op == 1:                                 # contrast
                    m = (fr * luma).sum(-1).mean(dim=(0, 1))
                    m = m[None, None, :, None]
                    fr = m + cs[i] * (fr - m)
                else:                                         # saturation
                    gray = (fr * luma).sum(-1, keepdim=True)
                    fr = gray + ss[i] * (fr - gray)
                fr = torch.clamp(fr, 0.0, 255.0)
            x[i] = fr.reshape(h, w, img_num * 3)
    if "drop" in params:
        for i, f in params["drop"].nonzero().tolist():
            x[i, :, :, 3 * f:3 * f + 3] = 0.0
    return x
