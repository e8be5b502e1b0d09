"""Transform pipelines of the clip dataset.

Counterparts of ``deepfake_detection_tpu/data/transforms_factory.py``:

* :func:`transforms_deepfake_train_passthrough`, the host half of the
  device augment chain (``--augment-device on``, the only form the port
  runs): one passthrough stage that consumes the chain's draws;
* :func:`transforms_deepfake_eval_v3`: a random (the reference's eval) or
  centre crop of every frame, then concatenation.

Normalization, jitter and erasing are not here: the host emits uint8
``(H, W, 3F)`` and the device prologue does the rest (``data/loader.py``).
"""

from __future__ import annotations

from typing import Tuple, Union

from .transforms import (Compose, DeviceAugmentPassthrough, MultiCenterCrop,
                         MultiConcate, MultiRandomCrop)

__all__ = ["transforms_deepfake_train_passthrough",
           "transforms_deepfake_eval_v3"]


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
