"""RandomErasing of a normalized NHWC batch, frame by frame.

Counterpart of ``deepfake_detection_tpu/data/random_erasing.py`` ('Random
Erasing Data Augmentation', Zhong et al.), split in two:

* :func:`draw_random_erasing` draws on an explicit ``torch.Generator``, one
  draw a (sample, frame): the erase coin (``probability``), a count in
  ``[min_count, max_count]``, and for each box 10 candidate (area, aspect)
  pairs (area fraction uniform in ``[min_area, max_area] / count``, aspect
  log-uniform), taking the first whose rounded size fits the frame, then a
  uniform top-left corner; the fill is zeros (``const``), one normal value
  a channel (``rand``) or one a pixel (``pixel``);
* :func:`apply_random_erasing` writes the boxes into the batch in draw
  order (a later box overwrites an earlier one).

The JAX package draws the same quantities from ``jax.random``, which torch
cannot reproduce; the tests replay its draws through
:func:`apply_random_erasing` and compare bitwise.  With ``num_splits > 1``
the first ``B // num_splits`` samples (the clean split) are not erased.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

__all__ = ["EraseBox", "draw_random_erasing", "apply_random_erasing",
           "NUM_ATTEMPTS"]

NUM_ATTEMPTS = 10


class EraseBox(NamedTuple):
    """One box: sample, frame, top, left, height, width and its fill
    (``None`` for zeros; ``(C,)`` or ``(height, width, C)`` otherwise)."""
    b: int
    f: int
    top: int
    left: int
    h: int
    w: int
    fill: Optional[torch.Tensor]


def draw_random_erasing(generator: torch.Generator, batch: int, height: int,
                        width: int, chans: int, probability: float = 0.5,
                        min_area: float = 0.02, max_area: float = 1 / 3,
                        min_aspect: float = 0.3,
                        max_aspect: Optional[float] = None,
                        mode: str = "const", min_count: int = 1,
                        max_count: Optional[int] = None,
                        num_splits: int = 0, img_num: int = 1
                        ) -> List[EraseBox]:
    """The boxes of one batch of ``(batch, height, width, chans)``; each
    frame has ``chans // img_num`` channels."""
    mode = (mode or "const").lower()
    assert mode in ("const", "rand", "pixel"), mode
    max_aspect = max_aspect or 1.0 / min_aspect
    max_count = max_count or min_count
    la_min, la_max = math.log(min_aspect), math.log(max_aspect)
    cpf = chans // img_num
    area = height * width
    g, dev = generator, generator.device
    start = batch // num_splits if num_splits > 1 else 0
    gate = torch.rand(batch, img_num, generator=g, device=dev) < probability
    gate[:start] = False
    count = torch.randint(min_count, max_count + 1, (batch, img_num),
                          generator=g, device=dev)
    n = (batch, img_num, NUM_ATTEMPTS)
    boxes = []
    for c in range(max_count):
        frac = min_area + (max_area - min_area) * torch.rand(
            n, generator=g, device=dev)
        target = frac * area / count[..., None]
        aspect = torch.exp(la_min + (la_max - la_min) * torch.rand(
            n, generator=g, device=dev))
        hh = torch.round(torch.sqrt(target * aspect)).to(torch.int64)
        ww = torch.round(torch.sqrt(target / aspect)).to(torch.int64)
        valid = (ww < width) & (hh < height)
        pick = valid.to(torch.int8).argmax(-1, keepdim=True)  # first fit
        h = hh.gather(-1, pick)[..., 0]
        w = ww.gather(-1, pick)[..., 0]
        ok = valid.any(-1) & (c < count) & gate
        u_top = torch.rand(batch, img_num, generator=g, device=dev)
        u_left = torch.rand(batch, img_num, generator=g, device=dev)
        top = torch.floor(u_top * (height - h + 1)).to(torch.int64)
        left = torch.floor(u_left * (width - w + 1)).to(torch.int64)
        for b, f in ok.nonzero().tolist():
            bh, bw = int(h[b, f]), int(w[b, f])
            if mode == "pixel":
                fill = torch.randn(bh, bw, cpf, generator=g, device=dev)
            elif mode == "rand":
                fill = torch.randn(cpf, generator=g, device=dev)
            else:
                fill = None
            boxes.append(EraseBox(b, f, int(top[b, f]), int(left[b, f]),
                                  bh, bw, fill))
    return boxes


def apply_random_erasing(x: torch.Tensor, boxes: List[EraseBox],
                         img_num: int) -> torch.Tensor:
    """Write ``boxes`` into ``x (B, H, W, C)`` in place, in order."""
    cpf = x.shape[-1] // img_num
    for bx in boxes:
        region = x[bx.b, bx.top:bx.top + bx.h, bx.left:bx.left + bx.w,
                   bx.f * cpf:(bx.f + 1) * cpf]
        if bx.fill is None:
            region.zero_()
        else:
            region.copy_(bx.fill.to(x.dtype).expand_as(region),
                         non_blocking=True)
    return x
