"""PyTorch port, EfficientNet: arch decoding, the weight bridge, and eval
logits against the JAX package on CPU.

Whole-model comparisons use calibrated BN statistics: a freshly initialised
deep EfficientNet with unit running stats collapses its logits to ~1e-14,
where any two implementations agree.  Calibration is one JAX
``training=True, mutable=['batch_stats']`` pass of the model built with
``bn_momentum=1.0`` (running stats := the batch's); the weights then cross
the bridge (``convert.state_dict_from_flax``).  The same seeded numpy
inputs go through both packages, at 64² with batch 4: at B0's 32² with
batch 2 the last stages hold one pixel per channel and two samples, and
such stats amplify rounding by up to 1/sqrt(eps) per BN (even JAX's own
eval and train logits disagree there, 1.34 vs 1.28).  Tolerance: f32
logits within 1e-4 relative to the logit scale (max |logit|), the bound
for reassociation between XLA's and torch's convolutions through 10-16
blocks, where 2.3e-6 to 1.2e-5 was measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.models import efficientnet as j_eff
from deepfake_detection_tpu.models import efficientnet_builder as j_builder
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import create_model, efficientnet
from deepfake_detection_tpu_torch.models import efficientnet_builder
from deepfake_detection_tpu_torch.models.factory import resolve_device
from deepfake_detection_tpu_torch.params import make_score_fn
from deepfake_detection_tpu_torch.runners import train as train_runner
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

# (model, kwargs, NHWC input shape): B0 and the flagship cut to 10 blocks
# at a quarter of its width
CASES = {
    "efficientnet_b0": ({}, (4, 64, 64, 3)),
    "efficientnet_deepfake_v4": (dict(num_classes=2, in_chans=12,
                                      channel_multiplier=0.25,
                                      depth_multiplier=0.34),
                                 (4, 64, 64, 12)),
}


@pytest.mark.parametrize("cm,dm", [(1.0, 1.0), (2.0, 3.1), (0.25, 0.34)])
def test_arch_decoding_matches_jax(cm, dm):
    """B0, the flagship's B7 scaling and the reduced test config decode to
    the same per-block kwargs in both packages."""
    j_dec = j_builder.decode_arch_def(j_eff._EFFICIENTNET_ARCH, dm)
    t_dec = efficientnet_builder.decode_arch_def(
        efficientnet._EFFICIENTNET_ARCH, dm)
    assert t_dec == j_dec
    assert efficientnet_builder.build_block_configs(t_dec, cm) == \
        j_builder.build_block_configs(j_dec, cm)


def test_flagship_has_55_depthwise_stages():
    model = create_model("efficientnet_deepfake_v4", num_classes=2,
                         in_chans=12, device="cpu")
    assert sum(len(stage) for stage in model.blocks) == 55
    assert model.conv_stem.weight.shape == (256, 12, 3, 3)
    assert model.conv_head.weight.shape[0] == 256


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_case(request):
    return request.param, _jax_calibrated(request.param, seed=2)


def _jax_calibrated(name, seed):
    """JAX model, its init variables, the same with running stats set to
    one batch's, and that batch."""
    kwargs, shape = CASES[name]
    jm = j_create_model(name, bn_momentum=1.0, **kwargs)
    variables = j_init_model(jm, jax.random.PRNGKey(seed), shape)
    xcal = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    _, upd = jax.jit(lambda v, x: jm.apply(
        v, x, training=True, mutable=["batch_stats"]))(variables,
                                                       jnp.asarray(xcal))
    return jm, variables, {"params": variables["params"],
                           "batch_stats": upd["batch_stats"]}, xcal


def _port(name, variables, **extra):
    kwargs, _ = CASES[name]
    model = create_model(name, device="cpu", **kwargs, **extra)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables)), strict=True)
    return model


def test_bridge_round_trip_is_exact(jax_case):
    """JAX tree → ``state_dict_from_flax`` → port → ``state_dict()`` →
    ``tools/convert_torch_checkpoint.convert_state_dict`` gives the JAX
    tree back exactly."""
    name, (_, _, variables, _) = jax_case
    back = convert_state_dict(_port(name, variables).state_dict())
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, dict(variables)))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_eval_logits_match_jax(jax_case):
    name, (jm, _, calibrated, _) = jax_case
    x = np.random.default_rng(3).standard_normal(CASES[name][1]).astype(
        np.float32)
    ref = np.asarray(jm.apply(calibrated, jnp.asarray(x), training=False))
    # non-degenerate: calibrated logits are O(1), not the ~1e-14 of init
    assert 1e-2 < np.abs(ref).max() < 1e3
    model = _port(name, calibrated)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale, np.abs(got - ref).max()
    scores = make_score_fn(model)(x)
    np.testing.assert_allclose(scores, np.asarray(jax.nn.softmax(ref)),
                               rtol=0, atol=1e-4)


def test_train_mode_calibration_matches_jax(jax_case):
    """The port's train-mode forward (dw kernel path with an identity
    epilogue, then batch-statistics BN) sets the same running stats as the
    JAX calibration pass and gives the same train-mode logits."""
    name, (jm, variables, calibrated, xcal) = jax_case
    ref_logits = np.asarray(jm.apply(variables, jnp.asarray(xcal),
                                     training=True,
                                     mutable=["batch_stats"])[0])
    model = _port(name, variables, bn_momentum=1.0).train()
    with torch.no_grad():
        logits = model(torch.from_numpy(xcal).permute(0, 3, 1, 2)).numpy()
    assert np.abs(logits - ref_logits).max() <= \
        1e-4 * np.abs(ref_logits).max()
    # each stat against its own scale: a mean against the channel spread
    # sqrt(var) (many means are ~1e-7 rounding noise), a var against var
    want = state_dict_from_flax(jax.tree.map(np.asarray, calibrated))
    got = model.state_dict()
    for k in want:
        if k.endswith("running_var"):
            base = k[:-len("running_var")]
            spread = np.sqrt(want[k].numpy().max())
            for leaf, scale in (("running_mean", spread),
                                ("running_var", spread ** 2)):
                diff = np.abs(got[base + leaf].numpy()
                              - want[base + leaf].numpy()).max()
                assert diff <= 1e-4 * scale, (base + leaf, diff, scale)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("efficientnet_b0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    # the training entry point too: cuda unless --device cpu
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_runner.launch_main(["--model", "efficientnet_b0",
                                  "--model-version", "", "--epochs", "1"])
    # and the transformer families, through the factory and the runner
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("timesformer_tiny_patch16_224", in_chans=12,
                     attn_impl="flash")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_runner.launch_main(["--model", "timesformer_tiny_patch16_224",
                                  "--model-version", "", "--attn-impl",
                                  "flash", "--input-size-v2", "12,32,32",
                                  "--epochs", "1"])
