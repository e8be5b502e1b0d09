"""PyTorch port, preprocessing: numpy ``resize`` / canvas / normalize
against the JAX package's ``params.py`` (which resizes with Pillow).

The port's ``resize`` reproduces ``PIL.Image.resize(..., BILINEAR)`` in
numpy, so every comparison here is bit equality.
"""

import numpy as np
import pytest
import torch

from deepfake_detection_tpu import params as jparams
from deepfake_detection_tpu_torch import params as tparams

torch.set_num_threads(2)

# (H, W) source sizes: portrait, landscape, square, up-scale, strong
# down-scale, near-canvas, and the 600² identity
SIZES = [(480, 270), (270, 480), (333, 333), (97, 61), (1901, 1203),
         (601, 599), (600, 600), (20, 1000)]


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("canvas", [600, 64])
@pytest.mark.parametrize("hw", SIZES)
def test_resize_is_bit_equal_to_pillow(hw, canvas):
    img = _image(*hw, seed=hw[0] * 7 + hw[1])
    ref = jparams.resize(img, (canvas, canvas))
    got = tparams.resize(img, (canvas, canvas))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", SIZES)
def test_canvas_and_normalize_are_bit_equal(hw):
    img = _image(*hw, seed=hw[0] + hw[1])
    ref = jparams.prepare_canvas(img, 96)
    got = tparams.prepare_canvas(img, 96)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tparams.normalize_replicate(got),
                                  jparams.normalize_replicate(ref))
    frames = [tparams.prepare_canvas(_image(*hw, seed=s), 96)
              for s in range(4)]
    np.testing.assert_array_equal(tparams.normalize_concat(frames, 4),
                                  jparams.normalize_concat(frames, 4))


def test_constants_match():
    np.testing.assert_array_equal(tparams.img_mean, jparams.img_mean)
    np.testing.assert_array_equal(tparams.img_std, jparams.img_std)
    assert (tparams.image_max_height, tparams.image_max_width,
            tparams.img_num) == (jparams.image_max_height,
                                 jparams.image_max_width, jparams.img_num)


def test_normalize_concat_rejects_wrong_count():
    with pytest.raises(ValueError):
        tparams.normalize_concat([np.zeros((4, 4, 3), np.uint8)], 4)
