"""PyTorch port, the train runner's normalization by model name (fault F1),
its input size (divergence D1) and the model, schedule and pack flags,
against the JAX package on CPU.

* The mean/std rule of every JAX registered name, and the prologue's
  output: the first eval batch of a seeded clip tree through the port's
  runner (``build_loaders``) bitwise the JAX loader's, built with the mean
  and std the JAX runner resolves (``resolve_data_config`` of its
  ``TrainConfig``), in f32 and bf16, for ``spnasnet_100`` (Inception's
  0.5: ``nasnet`` in its name), the flagship (ImageNet's) and a
  ``--mean``/``--std`` override; one value for a 12-channel input is
  refused (the JAX runner replicates it to 12 and tiles that ×4, which its
  prologue cannot broadcast).
* Both packages' default input sizes side by side, and ``--input-size`` /
  ``--img-size`` resolving as JAX's ``TrainConfig.resolved_input_size``.
* The flags reach the factory as the JAX runner passes them;
  ``--num-classes`` 3 widens the mixup targets and drops the AUC in both;
  ``--pack-image-size`` is checked as JAX checks it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.config import TrainConfig as JTrainConfig
from deepfake_detection_tpu.data import config as j_dcfg
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.data import packed as j_packed
from deepfake_detection_tpu.registry import list_models as j_list_models
from deepfake_detection_tpu.runners import train as j_train_runner
from deepfake_detection_tpu_torch.data import config as t_dcfg
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.data import packed as t_packed
from deepfake_detection_tpu_torch.runners import train as t_runner
from deepfake_detection_tpu_torch.train.trainer import validate
from test_torch_data import make_clip_tree
from test_torch_efficientnet_family import _factory_kwargs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_clip_tree(str(tmp_path_factory.mktemp("clips")), n_real=3,
                          n_fake=4, hw=(40, 40))


def test_mean_std_by_model_name_matches_jax():
    names = j_list_models()
    odd = []
    for name in names:
        assert t_dcfg.get_mean_by_model(name) == j_dcfg.get_mean_by_model(
            name), name
        assert t_dcfg.get_std_by_model(name) == j_dcfg.get_std_by_model(
            name), name
        if t_dcfg.get_mean_by_model(name) != t_dcfg.IMAGENET_DEFAULT_MEAN:
            odd.append(name)
    assert "spnasnet_100" in odd and "mnasnet_100" not in odd
    assert len(odd) == 19, odd


def _argv(tree, model, chans, dtype, extra=()):
    return ["--data", tree, "--model", model, "--model-version", "",
            "--input-size-v2", f"{chans},32,32", "-b", "2", "--workers",
            "1", "--compute-dtype", dtype, *extra]


PROLOGUE_CASES = [
    ("spnasnet_100", 12, ()), ("efficientnet_deepfake_v4", 12, ()),
    ("resnet50d", 12, ("--mean", "0.4,0.5,0.6", "--std", "0.2,0.25,0.3")),
    ("spnasnet_100", 3, ("--mean", "0.45", "--std", "0.25"))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,chans,extra", PROLOGUE_CASES,
                         ids=["spnasnet", "flagship", "override",
                              "one_value_3ch"])
def test_prologue_normalizes_as_the_jax_runner(tree, model, chans, extra,
                                               dtype):
    argv = _argv(tree, model, chans, dtype, extra)
    jcfg = JTrainConfig.from_args(argv)
    dc = j_dcfg.resolve_data_config(jcfg.to_dict(), verbose=False)
    _, jeval = j_train_runner.build_datasets(jcfg, dc["input_size"])
    jl = j_loader.create_deepfake_loader_v3(
        jeval, dc["input_size"], 4, is_training=False,
        eval_crop=jcfg.eval_crop, mean=dc["mean"], std=dc["std"],
        dtype=jnp.dtype(dtype), num_workers=1, seed=jcfg.seed)
    tcfg = t_runner.parse_args(argv + ["--device", "cpu"])
    assert tcfg.mean_std() == (tuple(dc["mean"]), tuple(dc["std"]))
    train_l, eval_l = t_runner.build_loaders(
        tcfg, "cpu", *t_runner.build_datasets(tcfg))
    try:
        want = next(iter(jl))
        got = next(iter(eval_l))
    finally:
        train_l.close()
        eval_l.close()
    assert got[0].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got[0].float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_one_value_for_twelve_channels_is_refused(tree):
    """JAX: one ``--mean`` value becomes 12 (``in_chans``), then the loader
    tiles it ×4 (``img_num``) into 48 values that cannot broadcast against
    a 12-channel batch; the port refuses it at the loader's build."""
    argv = _argv(tree, "resnet50d", 12, "float32", ("--mean", "0.5"))
    dc = j_dcfg.resolve_data_config(JTrainConfig.from_args(argv).to_dict(),
                                    verbose=False)
    assert len(dc["mean"]) == 12
    with pytest.raises(ValueError):
        np.broadcast_shapes((1, 1, 1, len(dc["mean"]) * 4), (2, 32, 32, 12))
    tcfg = t_runner.parse_args(argv + ["--device", "cpu"])
    assert tcfg.mean_std()[0] == dc["mean"]
    with pytest.raises(ValueError, match="one value per RGB channel"):
        t_runner.build_loaders(tcfg, "cpu", *t_runner.build_datasets(tcfg))


@pytest.mark.parametrize("model", ["efficientnet_deepfake_v4", "resnet50d"])
def test_default_input_sizes_side_by_side(model):
    """D1: with no size flag the JAX runner resolves 3×224² whatever the
    model (the flagship would get 3 input channels); the port keeps the
    model's ``default_cfg`` (CLI > model config)."""
    jcfg = JTrainConfig.from_args(["--model", model])
    assert jcfg.resolved_input_size == (3, 224, 224)
    assert j_dcfg.resolve_data_config(jcfg.to_dict(), verbose=False)[
        "input_size"] == (3, 224, 224)
    port = t_runner.parse_args(["--model", model]).input_size()
    assert port == {"efficientnet_deepfake_v4": (12, 600, 600),
                    "resnet50d": (3, 224, 224)}[model]


@pytest.mark.parametrize("flags", [
    ["--input-size", "12,64,64"], ["--img-size", "96"],
    ["--input-size-v2", "12,32,32", "--input-size", "3,64,64"],
    ["--input-size", "3,64,64", "--img-size", "96"],
    ["--img-size", "80", "--input-size-v2", "12,48,48"]])
def test_size_flags_resolve_as_jax(flags):
    argv = ["--model", "resnet50d"] + flags
    jcfg = JTrainConfig.from_args(argv)
    want = jcfg.resolved_input_size
    assert j_dcfg.resolve_data_config(jcfg.to_dict(), verbose=False)[
        "input_size"] == want
    assert t_runner.parse_args(argv).input_size() == want


def test_model_flags_reach_the_factory_as_jax(monkeypatch):
    jkw, tkw = _factory_kwargs(monkeypatch, [
        "--model", "resnet50d", "--model-version", "", "--input-size-v2",
        "12,64,64", "--num-classes", "3", "--drop", "0.2", "--drop-path",
        "0.1", "--bn-eps", "1e-3", "--drop-block", "0.1"])
    for k in ("model", "num_classes", "in_chans", "drop_rate",
              "drop_path_rate", "drop_block_rate", "bn_eps", "global_pool"):
        assert jkw.get(k) == tkw.get(k), (k, jkw.get(k), tkw.get(k))


def test_schedule_and_ema_flags_parse_as_jax():
    argv = ["--cooldown-epochs", "3", "--patience-epochs", "4", "--min-lr",
            "2e-6", "--model-ema-decay", "0.99"]
    jcfg, tcfg = JTrainConfig.from_args(argv), t_runner.parse_args(argv)
    for k in ("cooldown_epochs", "patience_epochs", "min_lr",
              "model_ema_decay"):
        assert getattr(tcfg, k) == getattr(jcfg, k), k


def test_three_classes_widen_mixup_and_drop_the_auc():
    """As the JAX runner: the mixup targets take ``--num-classes`` columns,
    and validation reports AUC for a two-class model only."""
    labels = np.array([0, 2, 1, 2])
    np.testing.assert_array_equal(
        t_mixup.mixup_target_np(labels, 3, 0.7, 0.1),
        j_mixup.mixup_target_np(labels, 3, 0.7, 0.1))
    cfg = t_runner.parse_args([
        "--dataset", "synthetic", "--model", "resnet18", "--model-version",
        "", "--input-size-v2", "3,32,32", "-b", "2", "--num-classes", "3",
        "--device", "cpu", "--workers", "1", "--compute-dtype", "float32"])
    run = t_runner.setup(cfg)
    try:
        assert run.state.model.fc.out_features == 3
        metrics = validate(run.eval_step, run.state, run.eval_loader, cfg)
    finally:
        run.train_loader.close()
        run.eval_loader.close()
    assert "auc" not in metrics and np.isfinite(metrics["loss"])


def test_pack_image_size_is_checked_as_jax(tree, tmp_path):
    for bad in (["--pack-image-size", "32"],
                ["--pack-image-size", "-1", "--data-packed", "x"]):
        with pytest.raises(ValueError, match="pack-image-size"):
            JTrainConfig.from_args(["--data", tree] + bad)
        with pytest.raises(ValueError, match="pack-image-size"):
            t_runner.parse_args(["--data", tree] + bad)
    pack = str(tmp_path / "pack")
    t_packed.write_pack(tree, pack, workers=1)
    argv = ["--data", tree, "--data-packed", pack, "--input-size-v2",
            "12,32,32", "--model", "resnet18", "--model-version", ""]
    for size, ok in ((40, True), (32, False)):
        jcfg = JTrainConfig.from_args(argv + ["--pack-image-size", str(size)])
        tcfg = t_runner.parse_args(argv + ["--pack-image-size", str(size)])
        if ok:
            assert len(j_train_runner.build_datasets(
                jcfg, (12, 32, 32), pack_dir=pack, pack_image_size=size)[0]) \
                == len(t_runner.build_datasets(tcfg)[0])
            continue
        with pytest.raises(j_packed.PackedCacheStale):
            j_train_runner.build_datasets(jcfg, (12, 32, 32), pack_dir=pack,
                                          pack_image_size=size)
        with pytest.raises(t_packed.PackedCacheStale):
            t_runner.build_datasets(tcfg)
    assert os.path.isdir(pack)
