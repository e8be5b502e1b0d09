"""Transform pipelines of the clip dataset.

Counterparts of ``deepfake_detection_tpu/data/transforms_factory.py``:

* :func:`transforms_deepfake_train_v3`, the host augment chain
  (``--augment-device off``, the default): the geometric chain as one
  native warp or (``fused_geom=False``) as its four sequential stages,
  the blur, the colour jitter and the flicker when the loader keeps them
  on the host, then the concatenation;
* :func:`transforms_deepfake_train_passthrough`, the host half of the
  device augment chain (``--augment-device on``): one passthrough stage
  that consumes the chain's draws;
* :func:`transforms_deepfake_eval_v3`: a random (the reference's eval) or
  centre crop of every frame, then concatenation.

Normalization and erasing are not here: the host emits uint8
``(H, W, 3F)`` and the device prologue does the rest (``data/loader.py``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

from .transforms import (Compose, DeviceAugmentPassthrough, MultiBlur,
                         MultiCenterCrop, MultiColorJitter, MultiConcate,
                         MultiFlicker, MultiFusedGeometric, MultiRandomCrop,
                         MultiRandomHorizontalFlip, MultiRandomResize,
                         MultiRotate, MultiToNumpy)

__all__ = ["transforms_deepfake_train_v3",
           "transforms_deepfake_train_passthrough",
           "transforms_deepfake_eval_v3"]


def transforms_deepfake_train_v3(
        img_size: Union[int, Tuple[int, int]] = 600,
        color_jitter: Any = 0.4, flicker: float = 0.0,
        rotate_range: float = 0, blur_radius: Optional[float] = None,
        blur_prob: float = 0.0, fused_geom: bool = True) -> Compose:
    """The four-frame train chain on the host, stage for stage the JAX
    one: geometry (``fused_geom``: one native warp; else rotate, flip,
    resize 2/3–3/2, pad and crop), ``MultiBlur`` when ``blur_prob`` > 0
    (``blur_radius`` None blurs with radius 0, a copy, as the JAX factory
    does), ``MultiColorJitter`` unless ``color_jitter`` is None (a number
    for brightness, contrast and saturation, or three or four values),
    ``MultiFlicker`` when ``flicker`` > 0, then the concatenation."""
    blur_radius = 0 if blur_radius is None else blur_radius
    if fused_geom:
        primary: list = [MultiFusedGeometric(
            img_size, rotate_range=rotate_range, scale=(2.0 / 3, 3.0 / 2.0))]
    else:
        primary = [MultiRotate(rotate_range), MultiRandomHorizontalFlip(),
                   MultiRandomResize(scale=(2.0 / 3, 3.0 / 2.0)),
                   MultiRandomCrop(img_size, pad_if_needed=True)]
    if blur_prob > 0.0:
        primary.append(MultiBlur(blur_prob, blur_radius))
    secondary = []
    if color_jitter is not None:
        if isinstance(color_jitter, (list, tuple)):
            assert len(color_jitter) in (3, 4)
        else:
            color_jitter = (float(color_jitter),) * 3
        secondary.append(MultiColorJitter(*color_jitter))
    if flicker > 0.0:
        secondary.append(MultiFlicker(flicker))
    return Compose(primary + secondary + [MultiToNumpy(), MultiConcate()])


def transforms_deepfake_train_passthrough(
        img_size: Union[int, Tuple[int, int]] = 600,
        rotate_range: float = 0, blur_prob: float = 0.0) -> Compose:
    """The train chain's host stage: draws consumed, raw clip out (scale
    range fixed at the chain's 2/3 to 3/2)."""
    return Compose([DeviceAugmentPassthrough(
        img_size, rotate_range=rotate_range, scale=(2.0 / 3, 3.0 / 2.0),
        blur_prob=blur_prob)])


def transforms_deepfake_eval_v3(img_size: Union[int, Tuple[int, int]] = 224,
                                crop: str = "random") -> Compose:
    """Eval: ``crop='random'`` (pad if needed, one window a clip) or
    ``'center'``."""
    assert crop in ("random", "center"), crop
    crop_t = (MultiRandomCrop(img_size, pad_if_needed=True)
              if crop == "random" else MultiCenterCrop(img_size))
    return Compose([crop_t, MultiConcate()])
