"""PyTorch port, one f32 train step of ``resnet26d`` (deep stem, avg-down
shortcuts) and of ``seresnext26t_32x4d`` (tiered stem, grouped 3×3s, SE)
against the JAX package's step run in f64 on CPU.

As ``test_torch_efficientnet_family.py``'s ``check_train_step``: one
rmsproptf step with ``test_torch_train.py``'s clip on soft mixup targets,
from the seeded weights as built (each block's last BN zero-initialized,
the families' default) with ``test_torch_resnet_models.py``'s calibrated
statistics; the loss
within 1e-4 relative, each parameter's update within
``test_torch_train.py``'s bound (1e-4 of the leaf's change, plus 2 f32
ulps of its magnitude, plus that file's gradient floor), the BN running
statistics within 1e-4 of their scale.  The reference is f64 because JAX's
own f32 gradients of a ReLU stem are 2e-3 off its f64 ones where the
port's f32 ones are 1e-5 off (ROADMAP, reference caveats).  DropBlock and
drop path are off: the port draws from a ``torch.Generator``, JAX from its
keys.

The weights are the families' own init because with every last BN at a
nonzero scale a random 26-layer net's train-mode gradients are
ill-conditioned: JAX's own f32 gradients were up to 0.46 of a leaf's
scale off its f64 ones (resnet26d and seresnext26t_32x4d at unit scales,
batch 4 and 8), the port's up to 0.22; with the zero-initialized ones the
port's f32 gradients are within 1e-5 of the JAX f64 ones (JAX's f32 within
8e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from test_torch_resnet_models import (IN_CHANS, NUM_CLASSES, _nchw,
                                      _np_tree, by_name, jax_calibrated)
from test_torch_train import (CLIP, GRAD_FLOOR, LR, _bn_stats_close,
                              _close_change, _close_rel, _opt_cfg)

SHAPE = (4, 64, 64, IN_CHANS)


@pytest.mark.parametrize("name", ["resnet26d", "seresnext26t_32x4d"])
def test_train_step_matches_jax_f64(name):
    args = by_name(name)
    jc = jax_calibrated(**args, small_last_bn=False)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    y = j_mixup.mixup_target_np(rng.integers(0, NUM_CLASSES, SHAPE[0]),
                                NUM_CLASSES, 0.7, 0.1).astype(np.float32)
    jm = j_create_model(name, num_classes=NUM_CLASSES, in_chans=IN_CHANS)
    tx = j_create_opt(_opt_cfg("rmsproptf"), learning_rate=LR)
    jstep = j_make_step(jm, tx, j_losses.soft_target_cross_entropy,
                        clip_grad=CLIP, donate=False)
    with jax.enable_x64(True):
        js = j_state(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                  jc.calibrated), tx, donate=False)
        js, jmet = jstep(js, jnp.asarray(x, jnp.float64),
                         jnp.asarray(y, jnp.float64), jax.random.PRNGKey(0))
        jloss = float(jmet["loss"])
        want = {k: v.numpy() for k, v in state_dict_from_flax(_np_tree(
            {"params": js.params, "batch_stats": js.batch_stats}),
            avg_down=args["avg_down"]).items()}

    model = args["build_port"]()
    model.load_state_dict(jc.model.state_dict(), strict=True)
    init = {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}
    ts = create_train_state(model, create_optimizer(_opt_cfg("rmsproptf"),
                                                    model, LR))
    tmet = make_train_step(t_losses.soft_target_cross_entropy,
                           clip_grad=CLIP)(ts, _nchw(x), torch.from_numpy(y))
    _close_rel(float(tmet["loss"]), jloss, f"{name} loss", rel=1e-4)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    stats = ("running_mean", "running_var", "num_batches_tracked")
    moved = 0
    for k in want:
        if not k.endswith(stats):
            _close_change(got[k], want[k], init[k], f"{name} {k}",
                          floor=LR * GRAD_FLOOR)
            moved += bool(np.any(got[k] != init[k]))
    assert moved > len(want) // 4, moved
    _bn_stats_close(got, want)
