"""PyTorch port, the MobileNetV3 family against the JAX package on CPU:
the registry's eleven names and their parameter layouts, eval logits and
the bridge round trip of each distinct path (the hard-swish
``mobilenetv3_large_100``, the ReLU-only ``tf_`` SAME-padded
``tf_mobilenetv3_small_minimal_100``, ``mobilenetv3_rw`` with its
bias-free ``conv_head``), one f32 train step of ``mobilenetv3_large_100``,
and the head: pool → 1×1 ``conv_head`` → act, no ``bn2``, ``pool=False``
ignored.  The helpers, inputs and tolerances are
``test_torch_efficientnet_family.py``'s.
"""

import numpy as np
import pytest
import torch

from deepfake_detection_tpu_torch.models import create_model
from test_torch_efficientnet_family import (SHAPE, _nchw, check_eval_logits,
                                            check_layouts, check_round_trip,
                                            check_train_step, fused_dw_stages,
                                            j_create_model, jax_calibrated,
                                            port_model)

torch.set_num_threads(2)

PATHS = ["mobilenetv3_large_100", "tf_mobilenetv3_small_minimal_100",
         "mobilenetv3_rw"]


def test_every_mobilenetv3_layout_matches_jax():
    assert check_layouts("mobilenetv3") >= 7


@pytest.mark.parametrize("name", PATHS)
def test_eval_logits_match_jax(name):
    check_eval_logits(name)


@pytest.mark.parametrize("name", PATHS)
def test_bridge_round_trip_is_exact(name):
    check_round_trip(name)


def test_train_step_matches_jax():
    """Against the JAX step in f64: its first block is ReLU, whose JAX f32
    gradients drift as mixnet_s's do (``check_train_step``)."""
    check_train_step("mobilenetv3_large_100", "float64")


@pytest.mark.parametrize("name,bias", [("mobilenetv3_large_100", True),
                                       ("mobilenetv3_rw", False)])
def test_head_pools_first_and_has_no_bn2(name, bias):
    model = create_model(name, num_classes=2, in_chans=12, device="cpu")
    assert not hasattr(model, "bn2")
    assert (model.conv_head.bias is not None) == bias
    jm = j_create_model(name, num_classes=2, in_chans=12)
    # every dw stage is a single k3/k5 kernel: all through the fused op
    assert sum(hasattr(b, "conv_dw") for s in model.blocks for b in s) == \
        fused_dw_stages(jm.block_configs)
    x = _nchw(np.random.default_rng(0).standard_normal(SHAPE).astype(
        np.float32))
    with torch.no_grad():
        feats = model(x, features_only=True)
        assert len(feats) == len(model.blocks)
        assert torch.equal(model(x, pool=False), model(x))


def test_catavgmax_widens_conv_head_as_jax():
    """The MobileNetV3 head pools before ``conv_head``, so ``catavgmax``
    doubles ``conv_head``'s input, not the classifier's, as in the JAX
    module."""
    name = "tf_mobilenetv3_small_minimal_100"
    check_eval_logits(name, global_pool="catavgmax")
    model = port_model(name, jax_calibrated(
        name, global_pool="catavgmax").calibrated, global_pool="catavgmax")
    assert model.conv_head.weight.shape[1] == \
        2 * model.blocks[-1][-1].out_chs
    assert model.classifier.in_features == model.conv_head.weight.shape[0]
