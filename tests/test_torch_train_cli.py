"""PyTorch port, the training runner and the non-finite guard on CPU.

* ``runners.train --device cpu`` on ``efficientnet_b0`` at 3×32² finishes a
  short epoch (8 steps, rmsproptf, mixup, EMA, clip-grad), validates and
  writes its checkpoints.
* Its ``last.pth.tar`` loads into the port (model and EMA streams) and,
  through ``tools/convert_torch_checkpoint.convert_state_dict``, into the
  JAX model, whose eval logits then match the port's within 1e-4 of the
  logit scale (f32 through 16 blocks, summed in different orders).
* A flag of ``scripts/train.sh`` that the port does not have raises,
  naming its ROADMAP item; a flag of the JAX runner outside that subset is
  an argparse error.
* A NaN batch through the guarded train step leaves every parameter, BN
  buffer, optimizer moment, EMA tensor and the step counter bitwise
  unchanged, reports ``nonfinite == 1``, and the next finite step trains.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu_torch import losses
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.models.helpers import (load_checkpoint,
                                                         load_state_dict)
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.checkpoint import CheckpointSaver
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model",
        "efficientnet_b0", "--model-version", "", "--input-size-v2",
        "3,32,32", "-b", "2", "--epochs", "1", "--opt", "rmsproptf",
        "--lr", "1e-3", "--mixup", "0.1", "--model-ema", "--clip-grad", "5",
        "--log-interval", "3", "--seed", "3"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    return runner.launch_main(ARGS + ["--output", str(out)])


def test_runner_trains_one_epoch_on_cpu(trained):
    out = trained["output_dir"]
    for name in ("last.pth.tar", "model_best.pth.tar",
                 "checkpoint-0.pth.tar", "args.json"):
        assert os.path.isfile(os.path.join(out, name)), name
    assert len(trained["train"]["step_s"]) == 8        # 16 samples / b2
    assert trained["train"]["nonfinite"] == 0
    assert np.isfinite(trained["train"]["loss"])
    assert np.isfinite(trained["eval"]["loss"])
    assert trained["best_epoch"] == 0
    ckpt = torch.load(os.path.join(out, "last.pth.tar"), map_location="cpu",
                      weights_only=True)
    assert {"epoch", "arch", "state_dict", "optimizer", "state_dict_ema",
            "args", "metric"} <= set(ckpt)
    assert ckpt["arch"] == "efficientnet_b0" and ckpt["epoch"] == 0


def test_checkpoint_loads_into_port_and_jax_with_equal_logits(trained):
    path = os.path.join(trained["output_dir"], "last.pth.tar")
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    fresh = create_model("efficientnet_b0", num_classes=2, device="cpu",
                         seed=11)
    for use_ema in (False, True):
        model = load_checkpoint(
            create_model("efficientnet_b0", num_classes=2, device="cpu",
                         seed=11), path, use_ema=use_ema)
        moved = [k for k, v in model.state_dict().items()
                 if not torch.equal(v, fresh.state_dict()[k])]
        assert moved, "the checkpoint did not change the weights"
        with torch.inference_mode():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        variables = convert_state_dict(
            {k: v.numpy() for k, v in load_state_dict(path, use_ema).items()})
        jm = j_create_model("efficientnet_b0", num_classes=2)
        want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, variables),
                                   jnp.asarray(x), training=False))
        scale = np.abs(want).max()
        assert np.all(np.isfinite(got)) and scale > 0
        assert np.abs(got - want).max() <= 1e-4 * scale, \
            (use_ema, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("flag", [
    ["--amp"], ["--reprob", "0.2"], ["--remax", "0.05"],
    ["--flicker", "0.05"], ["--rotate-range", "5"], ["--blur-prob", "0.05"],
    ["--label-balance"], ["--data", "/data"], ["--workers", "8"],
    ["--auto-resume"], ["--recovery-interval", "500"],
    ["--dataset", "deepfake_v3"]])
def test_unported_flags_raise_naming_their_roadmap_item(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        runner.parse_args(ARGS + flag)


@pytest.mark.parametrize("flag", [["--opt", "adamw"], ["--opt", "nvnovograd"]])
def test_unported_options_raise_at_setup(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        runner.setup(runner.parse_args(ARGS + flag))


@pytest.mark.parametrize("flag", [
    "--num-classes", "--drop", "--drop-path", "--bn-eps", "--opt-eps",
    "--momentum", "--weight-decay", "--warmup-lr", "--warmup-epochs",
    "--cooldown-epochs", "--patience-epochs", "--min-lr", "--model-ema-decay",
    "--grad-accum"])
def test_flags_outside_the_train_sh_subset_are_argparse_errors(flag):
    """The JAX runner's flags that ``scripts/train.sh`` does not set have no
    flag in the port (their TrainConfig fields keep the reference's
    defaults), so a value for one is refused, not silently run untested."""
    with pytest.raises(SystemExit):
        runner.parse_args(ARGS + [flag, "2"])


def test_runner_parses_the_flagship_train_sh_subset():
    cfg = runner.parse_args([
        "--dataset", "synthetic", "--model", "efficientnet_deepfake_v4",
        "--model-version", "v4", "--input-size-v2", "12,600,600", "-b", "3",
        "--opt", "rmsproptf", "--basic-lr", "5e-7", "--sched", "step",
        "--decay-epochs", "2", "--decay-rate", ".92", "--bn-momentum",
        "0.001", "--mixup", "0.1", "--model-ema", "--epochs", "1",
        "--eval-metric", "loss", "--experiment", "x"])
    assert cfg.device == "cuda"
    assert cfg.input_size() == (12, 600, 600)
    assert cfg.resolved_lr() == pytest.approx(1.5e-6)
    assert cfg.guard_nonfinite == "skip" and cfg.model_ema


def test_nan_batch_leaves_the_state_bitwise_unchanged():
    model = create_model("efficientnet_b0", num_classes=2, device="cpu",
                         bn_momentum=0.1)
    cfg = runner.TrainConfig(opt="rmsproptf")
    state = create_train_state(model, create_optimizer(cfg, model, 1e-2),
                               with_ema=True, ema_decay=0.9)
    step = make_train_step(losses.soft_target_cross_entropy, clip_grad=1.0,
                           nonfinite_guard=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 32, 32, generator=g).contiguous(
        memory_format=torch.channels_last)
    y = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4], [0.1, 0.9]])
    m = step(state, x, y)                 # a finite step first
    assert float(m["nonfinite"]) == 0.0 and int(state.step) == 1
    before = [t.clone() for t in state.tensors()]
    m = step(state, torch.full_like(x, float("nan")), y)
    assert float(m["nonfinite"]) == 1.0
    assert not np.isfinite(float(m["loss"]))
    after = state.tensors()
    assert len(after) == len(before) > 4 * len(list(model.parameters()))
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert int(state.step) == 1
    m = step(state, x, y)
    assert float(m["nonfinite"]) == 0.0 and int(state.step) == 2
    assert not torch.equal(state.tensors()[0], before[0])


def test_checkpoint_saver_keeps_the_top_k(tmp_path):
    model = create_model("efficientnet_b0", num_classes=2, device="cpu")
    state = create_train_state(model, create_optimizer(
        runner.TrainConfig(), model, 1e-3))
    saver = CheckpointSaver(str(tmp_path), decreasing=True, max_history=2)
    for epoch, metric in enumerate([0.5, 0.4, 0.6, 0.3]):
        best = saver.save_checkpoint(state, {"model": "b0"}, epoch, metric)
    assert best == (0.3, 3)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint-1.pth.tar", "checkpoint-3.pth.tar",
                     "last.pth.tar", "model_best.pth.tar"]
    assert torch.load(tmp_path / "model_best.pth.tar",
                      weights_only=True)["epoch"] == 3
