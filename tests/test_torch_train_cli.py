"""PyTorch port, the training runner and the non-finite guard on CPU.

* ``runners.train --device cpu`` on ``efficientnet_b0`` at 3×32² finishes a
  short epoch (8 steps, rmsproptf, mixup, EMA, clip-grad), validates and
  writes its checkpoints.
* Its ``last.pth.tar`` loads into the port (model and EMA streams) and,
  through ``tools/convert_torch_checkpoint.convert_state_dict``, into the
  JAX model, whose eval logits then match the port's within 1e-4 of the
  logit scale (f32 through 16 blocks, summed in different orders).
* ``--augment-device off`` parses (the default, as the JAX config's),
  with ``--host-geom`` and ``--host-color-jitter``, which raise beside
  ``on`` as they do in the JAX config; the data,
  augment, ``--amp`` and recovery flags of ``scripts/train.sh`` parse into
  ``TrainConfig`` with their values, and so does its whole argument list
  (as ``scripts/train_torch.sh`` passes it); the fields the JAX
  ``TrainConfig`` shares default as its do, the compute dtype to bf16; a flag of the JAX runner outside that subset is an
  argparse error.  The runs here pass ``--compute-dtype float32``: they
  are compared at f32 tolerances.
* From a clip tree (``test_torch_data.make_clip_tree``): the port's runner
  (``setup``, its loader and train step) on ``efficientnet_b0`` at 12×64²
  (at 32² the last stage's train-mode BN over 3 values of a channel is too
  ill-conditioned to compare a fresh model at 1e-4), batch 3, with
  ``--label-balance --rotate-range 5 --blur-prob 0.5 --mixup 0.1 --workers
  2 --color-jitter 0 --reprob 0 --augment-device on`` and ``--lr 1e-2
  --clip-grad 0.5`` (the
  clipped norm bounds the leaves whose gradient is rounding noise, as in
  ``test_torch_train.py``), against the JAX runner's
  ``build_datasets``, ``create_deepfake_loader_v3(...,
  augment_device=True, dtype=float32)`` and ``make_train_step`` from the
  same weights across the bridge.  The batches: labels and soft targets
  bitwise, images within the fractional warp's tolerance of
  ``test_torch_device_augment.py`` (the JAX warp's FMA flips a rounding by
  one grey level in a few values, and one such value can move a fresh
  model's train-mode loss past 1e-4 relative).  The steps, the JAX one fed the
  port's batches: the loss of each of 3 steps within 1e-4 relative, and
  every parameter after 1 and 3 steps within 1e-4 of its change (plus 2
  f32 ulps a step and the noise floor, as ``test_torch_train.py``).
"""

import dataclasses
import types
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import config as j_config
from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.runners import train as j_runner
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.models.helpers import (load_checkpoint,
                                                         load_state_dict)
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.checkpoint import CheckpointSaver
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from test_torch_data import make_clip_tree
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model",
        "efficientnet_b0", "--model-version", "", "--input-size-v2",
        "3,32,32", "-b", "2", "--epochs", "1", "--opt", "rmsproptf",
        "--lr", "1e-3", "--mixup", "0.1", "--model-ema", "--clip-grad", "5",
        "--log-interval", "3", "--seed", "3", "--compute-dtype", "float32"]


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


@pytest.mark.parametrize("flag", [["--augment-device", "off"]])
def test_unported_flags_raise_naming_their_roadmap_item(flag):
    """``--augment-device off`` (the host chain) parses now, with its two
    escape hatches; ``on`` with either of them raises as the JAX config
    does."""
    cfg = runner.parse_args(ARGS + flag + ["--host-geom",
                                           "--host-color-jitter"])
    assert (cfg.augment_device, cfg.host_geom, cfg.host_color_jitter) == \
        ("off", True, True)
    for hatch in ("--host-geom", "--host-color-jitter"):
        with pytest.raises(ValueError, match="pick one"):
            runner.parse_args(ARGS + ["--augment-device", "on", hatch])


@pytest.mark.parametrize("flag,field,value", [
    (["--reprob", "0.2"], "reprob", 0.2),
    (["--remax", "0.05"], "remax", 0.05),
    (["--flicker", "0.05"], "flicker", 0.05),
    (["--rotate-range", "5"], "rotate_range", 5.0),
    (["--blur-prob", "0.05"], "blur_prob", 0.05),
    (["--label-balance"], "label_balance", True),
    (["--data", "/data"], "data", "/data"),
    (["--workers", "8"], "workers", 8),
    (["--dataset", "deepfake_v3"], "dataset", "deepfake_v3"),
    (["--amp"], "amp", True),
    (["--auto-resume"], "auto_resume", True),
    (["--recovery-interval", "500"], "recovery_interval", 500)])
def test_train_sh_data_flags_parse_into_the_config(flag, field, value):
    """``scripts/train.sh``'s value of each flag reaches the config
    (``ARGS`` sets ``--dataset synthetic``; the flag comes after it)."""
    assert getattr(runner.parse_args(ARGS + flag), field) == value


def test_loader_backend_flags_parse_and_ring_depth_2_is_refused():
    cfg = runner.parse_args(ARGS)
    assert (cfg.loader_backend, cfg.ring_depth, cfg.worker_heartbeat) == \
        ("thread", 4, 120.0)
    cfg = runner.parse_args(ARGS + ["--loader-backend", "shm",
                                    "--ring-depth", "3",
                                    "--worker-heartbeat", "30"])
    assert (cfg.loader_backend, cfg.ring_depth, cfg.worker_heartbeat) == \
        ("shm", 3, 30.0)
    with pytest.raises(ValueError, match="--ring-depth must be >= 3"):
        runner.parse_args(ARGS + ["--ring-depth", "2"])
    with pytest.raises(SystemExit):
        runner.parse_args(ARGS + ["--loader-backend", "fork"])


def _train_sh_argv(script):
    """The runner's argument list in ``scripts/<script>`` as written, and
    the script's text."""
    text = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", script)).read()
    body = text.split(".runners.train \\\n", 1)[1].split('"${@:2}"')[0]
    return [w.strip('"') for w in body.replace("\\\n", " ").split()
            ], text


@pytest.mark.parametrize("script", ["train.sh", "train_torch.sh"])
def test_train_sh_whole_argument_list_parses(script):
    raw, text = _train_sh_argv(script)
    assert raw == _train_sh_argv("train.sh")[0]
    argv = [{"$1": "/data", "${DFD_EXPERIMENT:-flagship}": "flagship"}.get(
        a, a) for a in raw]
    cfg = runner.parse_args(argv)
    assert (cfg.amp, cfg.auto_resume, cfg.recovery_interval) == \
        (True, True, 500)
    assert (cfg.model, cfg.input_size(), cfg.batch_size, cfg.data) == (
        "efficientnet_deepfake_v4", (12, 600, 600), 3, "/data")
    assert runner.model_dtype(cfg) == torch.bfloat16
    if script == "train_torch.sh":
        assert "deepfake_detection_tpu_torch.runners.train" in text
        assert "75|85) ;;" in text


@pytest.mark.parametrize("flags,dtype", [
    ([], torch.bfloat16), (["--amp"], torch.bfloat16),
    (["--compute-dtype", "float32"], None),
    (["--amp", "--compute-dtype", "float32"], torch.float32)])
def test_compute_dtype_follows_the_jax_rule(flags, dtype):
    """bf16 by default and under --amp; f32 only with --compute-dtype
    float32 (the JAX runner's ``dtype=`` rule); the loaders' batches in the
    compute dtype."""
    cfg = runner.parse_args(ARGS[:-2] + flags)
    assert runner.model_dtype(cfg) == dtype
    model = runner.build_model(cfg, "cpu")
    assert model.conv_stem.compute_dtype == dtype
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_data_fields_default_as_the_jax_config():
    want = j_config.TrainConfig()
    got = runner.TrainConfig()
    names = [f.name for f in dataclasses.fields(got)
             if hasattr(want, f.name) and f.name not in (
                 "guard_nonfinite", "device", "input_size_v2")]
    assert len(names) > 40
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert (got.augment_device, want.augment_device) == ("off", "off")
    assert runner.parse_args([]).augment_device == "off"
    assert runner.parse_args([]).dataset == "deepfake_v3"


@pytest.mark.parametrize("flag", [["--opt", "adamw"], ["--opt", "nvnovograd"]])
def test_unported_options_raise_at_setup(flag):
    """Every optimizer of the JAX factory is ported: these build at setup
    (their state made at construction), and only a name outside the JAX
    factory raises."""
    from deepfake_detection_tpu_torch.optim import Adam, NvNovoGrad
    run = runner.setup(runner.parse_args(ARGS + flag))
    try:
        assert isinstance(run.state.optimizer,
                          {"adamw": Adam, "nvnovograd": NvNovoGrad}[flag[1]])
        assert all("count" in run.state.optimizer.state[p]
                   for p in run.state.model.parameters())
    finally:
        run.train_loader.close()
        run.eval_loader.close()
    with pytest.raises(ValueError, match="Invalid optimizer"):
        runner.setup(runner.parse_args(ARGS + [flag[0], flag[1] + "x"]))


#: flags of the JAX runner ported with this slice's optimization extras,
#: and the fields they set
_PORTED_FLAGS = {"--opt-eps": "opt_eps", "--momentum": "momentum",
                 "--weight-decay": "weight_decay", "--warmup-lr": "warmup_lr",
                 "--warmup-epochs": "warmup_epochs",
                 "--grad-accum": "grad_accum"}


@pytest.mark.parametrize("flag", [
    "--num-classes", "--drop", "--drop-path", "--bn-eps", "--opt-eps",
    "--momentum", "--weight-decay", "--warmup-lr", "--warmup-epochs",
    "--cooldown-epochs", "--patience-epochs", "--min-lr", "--model-ema-decay",
    "--grad-accum"])
def test_flags_outside_the_train_sh_subset_are_argparse_errors(flag):
    """The JAX runner's flags that the port has not ported have no flag
    (their TrainConfig fields keep the reference's defaults), so a value
    for one is refused, not silently run untested; the optimization flags
    ported beside ``--grad-accum`` parse into their fields."""
    if flag in _PORTED_FLAGS:
        cfg = runner.parse_args(ARGS + [flag, "2"])
        assert getattr(cfg, _PORTED_FLAGS[flag]) == 2
        return
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


TREE_ARGS = ["--model", "efficientnet_b0", "--model-version", "",
             "--input-size-v2", "12,64,64", "-b", "3", "--opt", "rmsproptf",
             "--lr", "1e-2", "--clip-grad", "0.5", "--bn-momentum", "0.1",
             "--label-balance",
             "--rotate-range", "5", "--blur-prob", "0.5", "--mixup", "0.1",
             "--workers", "2", "--color-jitter", "0", "--reprob", "0",
             "--seed", "4"]
TREE_STEPS = 3
# test_torch_train.py's floor: leaves whose gradient is rounding noise (a BN
# bias feeding the next BN) move by lr × 1e-7 of the clipped norm a step
TREE_FLOOR = 1e-2 * 1e-7 * 0.5


def _close_change(got, want, init, name, steps):
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    err = np.abs(got - want).max()
    bound = 1e-4 * np.abs(want - init).max() \
        + 2 * steps * np.finfo(np.float32).eps * np.abs(want).max() \
        + TREE_FLOOR * steps
    assert err <= bound, (name, err, bound)


@pytest.fixture(scope="module")
def tree_run(tmp_path_factory):
    """Each runner's first batches from one clip tree, and three train
    steps of each on the port's batches from one set of weights."""
    root = make_clip_tree(str(tmp_path_factory.mktemp("clips")), n_real=6,
                          n_fake=12)
    argv = TREE_ARGS + ["--data", root]
    # JAX: its runner's datasets, loader factory (device augment) and step;
    # f32 compute (the JAX runner's default compute dtype is bf16)
    jcfg = j_config.TrainConfig.from_args(
        argv + ["--augment-device", "on", "--compute-dtype", "float32"])
    jm = j_runner.build_model(jcfg, 12)
    variables = j_init_model(jm, jax.random.PRNGKey(4), (1, 64, 64, 12),
                             training=True)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), variables)
    jtrain, _ = j_runner.build_datasets(jcfg, (12, 64, 64))
    jl = j_loader.create_deepfake_loader_v3(
        jtrain, (12, 64, 64), 3, is_training=True,
        re_prob=jcfg.reprob, color_jitter=jcfg.color_jitter,
        collate_mixup=j_mixup.FastCollateMixup(jcfg.mixup, jcfg.smoothing, 2),
        flicker=jcfg.flicker, rotate_range=jcfg.rotate_range, blur_radius=1,
        blur_prob=jcfg.blur_prob, augment_device=True, dtype=jnp.float32,
        num_workers=jcfg.workers, seed=jcfg.seed)
    jl.set_epoch(0)
    j_batches = [(np.asarray(x), np.asarray(y))
                 for x, y in list(jl)[:TREE_STEPS]]
    tx = j_create_opt(jcfg, learning_rate=jcfg.lr)
    jstep = j_make_step(jm, tx, j_losses.create_loss_fn(jcfg),
                        clip_grad=jcfg.clip_grad, nonfinite_guard=True,
                        donate=False)
    js = j_state(jax.tree.map(jnp.asarray, variables), tx, donate=False)
    # port: its runner's setup with the same weights
    cfg = runner.parse_args(argv + ["--device", "cpu", "--compute-dtype",
                                    "float32", "--augment-device", "on"])
    init = state_dict_from_flax(variables)
    build = runner.build_model

    def build_from_jax(c, device):
        model = build(c, device)
        model.load_state_dict(init, strict=True)
        return model
    runner.build_model = build_from_jax
    try:
        run = runner.setup(cfg)
    finally:
        runner.build_model = build
    run.train_loader.set_epoch(0)
    assert len(run.train_loader) == len(jl) >= TREE_STEPS
    t_batches = list(run.train_loader)[:TREE_STEPS]
    j_out, t_out, gnorm = [], [], []
    for x, y in t_batches:
        js, m = jstep(js, jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                      jnp.asarray(y.numpy()), jax.random.PRNGKey(0))
        j_out.append((float(m["loss"]), {
            k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(
                lambda a: np.array(a, np.float32),
                {"params": js.params,
                 "batch_stats": js.batch_stats})).items()}))
        m = run.train_step(run.state, x, y)
        gnorm.append(float(m["gnorm"]))
        t_out.append((float(m["loss"]), {
            k: v.detach().numpy().copy()
            for k, v in run.state.model.state_dict().items()}))
    return dict(j=j_out, t=t_out, gnorm=gnorm,
                init={k: v.numpy() for k, v in init.items()},
                j_batches=j_batches,
                t_batches=[(x.permute(0, 2, 3, 1).numpy(), y.numpy())
                           for x, y in t_batches])


def test_runner_batches_from_a_clip_tree_match_jax(tree_run):
    std = np.tile(np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0, 4)
    for (xj, yj), (xt, yt) in zip(tree_run["j_batches"],
                                  tree_run["t_batches"]):
        np.testing.assert_array_equal(yt, yj)
        d = np.abs(xt - xj) * std                  # grey levels
        assert (d > 1e-3).mean() <= 1e-3 and d.max() <= 1.0 + 1e-3, \
            ((d > 1e-3).mean(), d.max())


@pytest.mark.parametrize("after", [1, TREE_STEPS])
def test_runner_from_a_clip_tree_matches_jax(tree_run, after):
    for i in range(after):
        lt, lj = tree_run["t"][i][0], tree_run["j"][i][0]
        assert np.isfinite(lt) and abs(lt - lj) <= 1e-4 * abs(lj), (i, lt, lj)
    got, want = tree_run["t"][after - 1][1], tree_run["j"][after - 1][1]
    init = tree_run["init"]
    moved = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            continue
        _close_change(got[k], w, init[k], k, after)
        moved += bool(np.any(w != init[k]))
    assert moved > 100


# ---------------------------------------------------------------------------
# validation AUC, summary.csv, the schedule flags, --mixup-off-epoch and
# --initial-checkpoint, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ties,masked", [(9, True, False), (64, True, True),
                                           (257, False, True),
                                           (40, False, False)])
def test_auc_matches_jax_with_ties_and_masks(n, ties, masked):
    from deepfake_detection_tpu.utils.metrics import auc as j_auc
    from deepfake_detection_tpu_torch.utils.metrics import auc
    rng = np.random.default_rng(n)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)            # many equal scores
    labels = rng.integers(0, 2, n)
    valid = (rng.random(n) > 0.3).astype(np.float32) if masked else None
    want = float(j_auc(jnp.asarray(scores), jnp.asarray(labels),
                       None if valid is None else jnp.asarray(valid)))
    got = auc(torch.from_numpy(scores), torch.from_numpy(labels),
              None if valid is None else torch.from_numpy(valid))
    assert abs(got - want) <= 1e-6, (got, want)
    # a masked row's score does not matter
    if masked:
        moved = scores.copy()
        moved[valid == 0] = rng.random(int((valid == 0).sum()))
        assert auc(torch.from_numpy(moved), torch.from_numpy(labels),
                   torch.from_numpy(valid)) == got


def test_validate_reports_auc_of_p_real_over_the_valid_rows():
    """``validate`` ranks P(real) = softmax[:, 1] over the epoch's valid
    rows, as the JAX ``validate``; a 3-class model reports no auc."""
    from deepfake_detection_tpu.utils.metrics import auc as j_auc
    from deepfake_detection_tpu_torch.train.trainer import validate
    rng = np.random.default_rng(4)
    batches, all_logits, all_y, all_v = [], [], [], []
    for b in range(3):
        logits = rng.standard_normal((4, 2)).astype(np.float32)
        y = rng.integers(0, 2, 4)
        v = np.array([1, 1, 1, b < 2], np.float32)
        batches.append((torch.from_numpy(logits), torch.from_numpy(y),
                        torch.from_numpy(v)))
        all_logits.append(logits)
        all_y.append(y)
        all_v.append(v)

    def eval_step(state, x, y, valid):
        return {"loss": torch.tensor(0.5), "prec1": torch.tensor(50.0),
                "count": valid.sum(), "logits": x}

    cfg = types.SimpleNamespace(log_interval=10)
    out = validate(eval_step, None, batches, cfg)
    p_real = jax.nn.softmax(jnp.asarray(np.concatenate(all_logits)))[:, 1]
    want = float(j_auc(p_real, jnp.asarray(np.concatenate(all_y)),
                       jnp.asarray(np.concatenate(all_v))))
    assert abs(out["auc"] - want) <= 1e-6
    three = [(torch.randn(4, 3), y, v) for _, y, v in batches]
    assert "auc" not in validate(eval_step, None, three, cfg)


def test_summary_csv_over_two_epochs_and_a_resume_is_the_jax_writers(
        tmp_path):
    """Two epochs of the port's runner, then a relaunch to a third with
    ``--auto-resume``: ``summary.csv`` holds one header and three rows
    (``epoch``, ``train_*`` without the step times, ``eval_*`` with
    ``auc``), byte for byte what the JAX runner's ``update_summary`` calls
    write for the same metrics."""
    import csv
    from deepfake_detection_tpu.utils.summary import \
        update_summary as j_update
    argv = ARGS + ["--eval-metric", "auc", "--auto-resume",
                   "--recovery-interval", "4", "--experiment", "run",
                   "--output", str(tmp_path / "out")]
    first = runner.launch_main(argv + ["--epochs", "2"])
    assert set(first["eval"]) == {"loss", "prec1", "auc"}
    runner.launch_main(argv + ["--epochs", "3"])
    path = tmp_path / "out" / "run" / "summary.csv"
    text = path.read_text()
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    assert text.count("epoch,") == 1
    assert list(rows[0]) == ["epoch", "train_loss", "train_prec1",
                             "train_learning_rate", "train_nonfinite",
                             "eval_loss", "eval_prec1", "eval_auc"]
    assert all(0.0 <= float(r["eval_auc"]) <= 1.0 for r in rows)
    # the JAX writer, fed the same rows as the JAX runner feeds it
    jpath = tmp_path / "jax.csv"

    def typed(v):
        return int(v) if v.lstrip("-").isdigit() else float(v)
    for r in rows:
        train = {k[len("train_"):]: typed(v) for k, v in r.items()
                 if k.startswith("train_")}
        ev = {k[len("eval_"):]: typed(v) for k, v in r.items()
              if k.startswith("eval_")}
        j_update(int(r["epoch"]), train, ev, str(jpath), None,
                 write_header=not jpath.exists())
    assert jpath.read_text() == text


def test_schedule_flags_parse_and_match_the_jax_factory():
    """``--warmup-epochs``, ``--warmup-lr``, ``--lr-noise*``,
    ``--lr-cycle-*``: the port's schedule against the JAX factory's for
    the same fields, epoch by epoch, and the warmup decision: the
    optimizer starts at the full lr (epoch 0), as in the JAX runner."""
    from deepfake_detection_tpu.scheduler.factory import \
        create_scheduler as j_sched
    from deepfake_detection_tpu_torch.scheduler.factory import \
        create_scheduler
    flags = ["--warmup-epochs", "3", "--warmup-lr", "1e-4", "--lr-noise",
             "0.2,0.7", "--lr-noise-pct", "0.5", "--lr-noise-std", "0.8",
             "--lr-cycle-mul", "2", "--lr-cycle-limit", "3",
             "--mixup-off-epoch", "4", "--epochs", "10"]
    cfg = runner.parse_args(ARGS + flags)
    assert (cfg.warmup_epochs, cfg.warmup_lr, cfg.lr_noise, cfg.lr_noise_pct,
            cfg.lr_noise_std, cfg.lr_cycle_mul, cfg.lr_cycle_limit,
            cfg.mixup_off_epoch) == (3, 1e-4, (0.2, 0.7), 0.5, 0.8, 2.0, 3, 4)
    for sched in ("step", "cosine", "tanh", "plateau"):
        c = dataclasses.replace(cfg, sched=sched)
        jc = j_config.TrainConfig(**{
            f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if hasattr(j_config.TrainConfig, f.name)})
        a, na = create_scheduler(c, base_lr=0.05)
        b, nb = j_sched(jc, base_lr=0.05)
        assert na == nb, sched
        for epoch in range(1, na + 1):
            assert a.step(epoch, 0.5) == b.step(epoch, 0.5), (sched, epoch)
    run = runner.setup(cfg)
    try:
        assert run.state.optimizer.param_groups[0]["lr"] == cfg.lr
        assert run.lr_scheduler.step(1) == pytest.approx(
            1e-4 + (cfg.lr - 1e-4) / 3, rel=1e-12)
    finally:
        run.train_loader.close()
        run.eval_loader.close()


def test_mixup_off_epoch_turns_the_loaders_mixup_off():
    from deepfake_detection_tpu_torch.train.trainer import train_one_epoch
    run = runner.setup(runner.parse_args(ARGS))
    try:
        loader = run.train_loader
        assert loader.mixup_enabled
        loader.mixup_enabled = False
        assert not loader.loader.collate_mixup.mixup_enabled
        loader.mixup_enabled = True
    finally:
        run.train_loader.close()
        run.eval_loader.close()

    class _Empty:
        mixup_enabled = True

        def __len__(self):
            return 0

        def __iter__(self):
            return iter(())

    for epoch, off, want in [(1, 2, True), (2, 2, False), (5, 0, True)]:
        empty = _Empty()
        cfg = types.SimpleNamespace(mixup=0.1, mixup_off_epoch=off,
                                    log_interval=1, recovery_interval=0)
        train_one_epoch(epoch, None, types.SimpleNamespace(
            optimizer=types.SimpleNamespace(param_groups=[{"lr": 0.1}])),
            empty, cfg)
        assert empty.mixup_enabled is want, (epoch, off)


SPLIT_KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
                depth_multiplier=0.1)


def _jax_tree(norm_layer, seed):
    from deepfake_detection_tpu.models import create_model as j_create
    jm = j_create("efficientnet_deepfake_v4", norm_layer=norm_layer,
                  **SPLIT_KW)
    v = j_init_model(jm, jax.random.PRNGKey(seed), (6, 32, 32, 12),
                     training=True)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32)
                                   + rng.standard_normal(a.shape)
                                   .astype(np.float32) * 0.1), v)


@pytest.mark.parametrize("src", ["batchnorm", "split2"])
def test_initial_checkpoint_expands_split_bn_as_jax(src, tmp_path):
    """A plain-BN checkpoint, and a split2 one, into a split3 model: the
    port's ``--initial-checkpoint`` load equals the JAX runner's
    ``expand_split_bn`` + ``filter_shape_mismatch`` on the same trees,
    tensor for tensor, every ``aux_bn.<i>`` a copy of its source BN."""
    from deepfake_detection_tpu.models.helpers import (
        expand_split_bn as j_expand, filter_shape_mismatch as j_filter)
    from deepfake_detection_tpu_torch.models.helpers import \
        load_initial_checkpoint
    ckpt_tree = _jax_tree("" if src == "batchnorm" else src, 1)
    init_tree = _jax_tree("split3", 2)
    merged, dropped = j_filter(init_tree, j_expand(ckpt_tree, init_tree))
    assert dropped == 0
    want = state_dict_from_flax(_np_tree_cli(merged))
    path = tmp_path / "init.pth.tar"
    torch.save({"state_dict": state_dict_from_flax(ckpt_tree)}, path)
    model = create_model("efficientnet_deepfake_v4", device="cpu",
                         norm_layer="split3", **SPLIT_KW)
    applied, total, n_drop, missing = load_initial_checkpoint(
        model, str(path), split_bn=True)
    got = model.state_dict()
    assert (applied, n_drop, missing) == (total, 0, 0)
    floats = [k for k in want if not k.endswith("num_batches_tracked")]
    assert len(floats) > 100
    for k in floats:
        assert torch.equal(got[k], want[k]), k
    aux = [k for k in floats if ".aux_bn." in k]
    assert aux
    for k in aux:
        base, leaf = k.split(".aux_bn.")[0], k.rsplit(".", 1)[1]
        src_key = f"{base}.{leaf}"
        if src == "split2" and ".aux_bn.0." in k:
            src_key = k                          # the checkpoint's own aux
        assert torch.equal(got[k], state_dict_from_flax(ckpt_tree)[src_key])


def _np_tree_cli(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def test_initial_checkpoint_runner_flag_drops_mismatches_and_refuses_junk(
        tmp_path):
    """Through the runner: a checkpoint of the same model with another head
    (3 classes) loads all but the classifier, which keeps its fresh init;
    a checkpoint that matches nothing raises."""
    other = create_model("efficientnet_b0", device="cpu", num_classes=3,
                         in_chans=3)
    path = tmp_path / "head3.pth.tar"
    torch.save({"state_dict": other.state_dict()}, path)
    run = runner.setup(runner.parse_args(ARGS + ["--initial-checkpoint",
                                                 str(path)]))
    try:
        sd, src = run.state.model.state_dict(), other.state_dict()
        kept = [k for k in sd if k.startswith("classifier")]
        assert kept and all(sd[k].shape != src[k].shape for k in kept)
        for k in sd:
            if k not in kept:
                assert torch.equal(sd[k], src[k]), k
        # the optimizer starts from the loaded weights (lookahead's and
        # the EMA's copies too)
        ema = run.state.ema.module.state_dict()
        assert torch.equal(ema["conv_stem.weight"], src["conv_stem.weight"])
    finally:
        run.train_loader.close()
        run.eval_loader.close()
    junk = tmp_path / "junk.pth.tar"
    torch.save({"state_dict": {"nothing.weight": torch.zeros(2)}}, junk)
    with pytest.raises(ValueError, match="matches no parameter"):
        runner.setup(runner.parse_args(ARGS + ["--initial-checkpoint",
                                               str(junk)]))
