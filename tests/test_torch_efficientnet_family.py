"""PyTorch port, the EfficientNet family generators against the JAX package
on CPU: the registry, every name's parameter layout, ``MixedConv2d`` and
``CondConv2d`` alone, eval logits and the bridge round trip per distinct
path, one train step of the three non-MobileNetV3 paths the JAX
conversion tests hold, the trainer's ``--gp``, ``--bn-tf`` and
``--drop-block``, and test-time pooling.  MobileNetV3 has its own file
(``test_torch_mobilenetv3.py``), which imports the helpers below.

Eval logits use calibrated BN statistics, as ``test_torch_efficientnet.py``
explains: one JAX train-mode pass with ``bn_momentum=1.0`` sets the running
stats to a batch's, then the weights cross the bridge; the logits are of a
64², batch-4 batch.  The calibration batch is 16 at 64² (64 samples a
channel at the deepest stage's 2×2): at batch 4 (16 samples) CondConv's
per-sample kernels left channels so ill-conditioned that the port in f32
and in f64 differed by 12.7 on logits of 1.3e4, twice its distance from
the JAX package.  The
JAX side runs its XLA composition (``fused_depthwise="off"``, its default),
the port its fused depthwise op's plain version (a CPU tensor), so a
single-kernel dw stage goes through the op the card launches.
Tolerances: logits within 1e-4 of the logit scale (max |logit|), as the
flagship's test; ``MixedConv2d``/``CondConv2d`` alone 1e-5 of the output's
scale; the train step's loss 1e-4 relative and its updates within
``test_torch_train.py``'s bound (1e-4 of each leaf's change, plus 2 f32
ulps of its magnitude, plus that file's gradient floor).

The layout check builds every registered name in both packages: the port's
module on the ``meta`` device (no memory), the JAX tree by ``jax.eval_shape``
of ``init``.  Names whose JAX modules differ only in padding and BN
arguments (a ``tf_`` twin, an ``_ap``/``_ns`` weight variant) have the same
tree, so it is traced once for all of them; each port module is built and
compared on its own.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.config import TrainConfig as JTrainConfig
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import test_time_pool as j_ttp
from deepfake_detection_tpu.ops import conv as j_conv
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.registry import list_models as j_list_models
from deepfake_detection_tpu.runners import train as j_train_runner
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import convert
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.models import efficientnet_blocks as blocks
from deepfake_detection_tpu_torch.models.efficientnet import fused_dw_stages
from deepfake_detection_tpu_torch.models import factory as t_factory
from deepfake_detection_tpu_torch.models import test_time_pool as t_ttp
from deepfake_detection_tpu_torch.ops import conv as t_conv
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.registry import list_models
from deepfake_detection_tpu_torch.registry import model_entrypoint
from deepfake_detection_tpu_torch.runners import train as t_train_runner
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from test_torch_train import (CLIP, GRAD_FLOOR, LR, _bn_stats_close,
                              _close_change, _close_rel, _opt_cfg)
from tools.convert_torch_checkpoint import (_convert_condconv,
                                            convert_state_dict)

torch.set_num_threads(2)

MODULES = ("efficientnet", "mobilenetv3")
SHAPE = (4, 64, 64, 12)           # NHWC: batch 4, 64², 4 RGB frames
CAL_SHAPE = (16, 64, 64, 12)      # the calibration batch: 64 samples a
                                  # channel at the deepest stage's 2×2
NUM_CLASSES = 2
# one constructor of each distinct path (the JAX conversion tests' four
# EfficientNet-family ones, then one per generator); MobileNetV3's in its
# own file
PATHS = ["tf_efficientnet_b0", "mixnet_s", "efficientnet_cc_b0_4e",
         "tf_mixnet_l", "tf_efficientnet_el", "mnasnet_100", "fbnetc_100",
         "spnasnet_100", "mobilenetv2_100"]
# each with the dtype of its JAX reference step: f32, but f64 for mixnet_s
# (see check_train_step)
TRAIN_PATHS = [("tf_efficientnet_b0", "float32"), ("mixnet_s", "float64"),
               ("efficientnet_cc_b0_4e", "float32")]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


# ---------------------------------------------------------------------------
# the registry and every name's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", MODULES)
def test_registry_matches_jax(module):
    assert list_models(module=module) == j_list_models(module=module)


def _jax_tree_key(jm):
    """The JAX module's fields that decide its parameter tree: all but the
    padding, the BN arguments, drop rates and the default config."""
    stages = tuple(tuple(tuple(sorted(
        (k, repr(v)) for k, v in cfg.items()
        if k not in ("pad_type", "drop_path_rate"))) for cfg in stage)
        for stage in jm.block_configs)
    return (stages, jm.num_classes, jm.num_features, jm.in_chans,
            jm.stem_size, jm.head_type, jm.head_bias, repr(jm.se_kwargs),
            jm.global_pool, jm.norm_layer)


def port_layout_from_jax(shapes):
    """The port's ``{name: shape}`` for a JAX variables tree of
    ``ShapeDtypeStruct``s, by the bridge's own name and layout rules (on
    zero-stride arrays: no memory), BN counters included."""
    out = {}
    for collection in ("params", "batch_stats"):
        for parts, leaf in convert._flatten(shapes.get(collection,
                                                       {})).items():
            name, is_bn = convert._map_path(parts)
            arr = np.broadcast_to(np.float32(0), leaf.shape)
            out[name] = tuple(convert._to_torch_layout(arr).shape)
            if is_bn:
                out[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = ()
    return out


def _port_layout(name, num_classes, in_chans):
    with torch.device("meta"):
        model = model_entrypoint(name)(num_classes=num_classes,
                                       in_chans=in_chans)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}, model


def check_layouts(module):
    """Every name of ``module``: the port's state-dict layout equals the JAX
    tree's through the bridge, and every single-kernel dw stage is k3 or
    k5 without dilation (the fused op's), so none raises."""
    traced = {}
    for name in j_list_models(module=module):
        jm = j_create_model(name)
        key = _jax_tree_key(jm)
        if key not in traced:
            traced[key] = port_layout_from_jax(jax.eval_shape(
                lambda r, jm=jm: jm.init(
                    {"params": r, "dropout": r},
                    jnp.zeros((1, 32, 32, jm.in_chans)), training=False),
                jax.random.PRNGKey(0)))
        got, model = _port_layout(name, jm.num_classes, jm.in_chans)
        assert got == traced[key], name
        for stage in jm.block_configs:
            for cfg in stage:
                k = cfg.get("dw_kernel_size")
                if cfg["block_type"] in ("ir", "ds") and \
                        not blocks.is_mixed(k):
                    assert k in (3, 5) and cfg["dilation"] == 1, (name, cfg)
        n_fused = sum(isinstance(getattr(b, "conv_dw", None), t_conv.Conv2d)
                      for stage in model.blocks for b in stage)
        assert n_fused == fused_dw_stages(jm.block_configs), name
    return len(traced)


def test_every_efficientnet_layout_matches_jax():
    assert check_layouts("efficientnet") > 20


def test_depthwise_route_is_fixed_at_build():
    """A single-kernel dw stage the kernel cannot take raises; a
    mixed-kernel one is torch convs; a single one the fused op."""
    with pytest.raises(NotImplementedError, match="fused depthwise"):
        blocks.InvertedResidual(16, 16, dw_kernel_size=7, exp_ratio=2.0)
    with pytest.raises(NotImplementedError, match="fused depthwise"):
        blocks.DepthwiseSeparableConv(16, 16, dw_kernel_size=3, dilation=2)
    mixed = blocks.InvertedResidual(16, 16, dw_kernel_size=[3, 5, 7],
                                    exp_ratio=2.0)
    assert isinstance(mixed.conv_dw, t_conv.MixedConv2d)
    single = blocks.InvertedResidual(16, 16, dw_kernel_size=5, exp_ratio=2.0,
                                     pad_type="same")
    assert type(single.conv_dw) is t_conv.Conv2d


# ---------------------------------------------------------------------------
# MixedConv2d and CondConv2d alone
# ---------------------------------------------------------------------------

def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _scale_close(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


@pytest.mark.parametrize("cin,cout,kernels,stride,depthwise,pad", [
    (10, 10, (3, 5, 7), 2, True, "same"),
    (11, 11, (3, 5), 1, True, ""),
    (11, 13, (1, 1), 1, False, ""),
    (9, 14, (3, 5, 7, 9), 2, False, "same")])
def test_mixed_conv_matches_jax(cin, cout, kernels, stride, depthwise, pad):
    x = np.random.default_rng(cin + cout).standard_normal(
        (2, 10, 9, cin)).astype(np.float32)
    jm = j_conv.MixedConv2d(cout, kernels, stride=stride, depthwise=depthwise,
                            padding=pad)
    v = jm.init(jax.random.PRNGKey(cin), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = t_conv.MixedConv2d(cin, cout, list(kernels), stride=stride,
                            depthwise=depthwise, padding=pad)
    tm.load_state_dict({
        f"{i}.weight": torch.from_numpy(convert._to_torch_layout(np.asarray(
            v["params"][f"conv_{i}"]["conv"]["kernel"])).copy())
        for i in range(len(kernels))}, strict=True)
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert tm[str(0)].weight.shape[0] >= tm[str(len(kernels) - 1)].weight \
        .shape[0]                                # the remainder goes first
    _scale_close(got, want)


def test_mixed_depthwise_split_mismatch_raises():
    with pytest.raises(ValueError, match="depthwise requires in == out"):
        t_conv.MixedConv2d(10, 12, [3, 5, 7], depthwise=True)


@pytest.mark.parametrize("cin,cout,k,stride,groups,pad,bias", [
    (8, 12, 1, 1, 1, "", False),
    (12, 12, 3, 2, 12, "same", False),
    (12, 12, 5, 1, 12, "", True),
    (12, 6, 1, 1, 1, "same", True)])
def test_cond_conv_matches_jax(cin, cout, k, stride, groups, pad, bias):
    rng = np.random.default_rng(cin * k + stride)
    x = rng.standard_normal((3, 10, 10, cin)).astype(np.float32)
    routing = rng.uniform(size=(3, 4)).astype(np.float32)
    jm = j_conv.CondConv2d(cout, k, stride=stride, groups=groups,
                           num_experts=4, padding=pad, use_bias=bias)
    v = jm.init(jax.random.PRNGKey(k), jnp.asarray(x), jnp.asarray(routing))
    if bias:      # the JAX init zeroes it: give it values to carry
        v = {"params": dict(v["params"], bias=jnp.asarray(
            rng.standard_normal((4, cout)).astype(np.float32)))}
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(routing)))
    tm = t_conv.CondConv2d(cin, cout, k, stride=stride, groups=groups,
                           num_experts=4, padding=pad, bias=bias)
    sd = {"weight": torch.from_numpy(convert._to_torch_layout(
        np.asarray(v["params"]["weight"])).copy())}
    if bias:
        sd["bias"] = torch.from_numpy(np.asarray(v["params"]["bias"]))
    tm.load_state_dict(sd, strict=True)
    assert tm.weight.shape == (4, cout * (cin // groups) * k * k)
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(routing)).permute(
            0, 2, 3, 1).numpy()
    _scale_close(got, want)


# ---------------------------------------------------------------------------
# per distinct path: eval logits and the bridge round trip
# ---------------------------------------------------------------------------

_CALIBRATED = {}


def jax_tree(sd, jm):
    """A port state dict as the JAX model ``jm``'s variables (numpy), by
    the tools converter (its CondConv pass, which unflattens the experts
    against ``jm``'s traced tree, for a CondConv model)."""
    if any(".routing_fn." in k for k in sd):
        shapes = jax.eval_shape(lambda r: jm.init(
            {"params": r, "dropout": r}, jnp.zeros((1, 32, 32, jm.in_chans)),
            training=False), jax.random.PRNGKey(0))
        return _np_tree(_convert_condconv(sd, shapes))
    return _np_tree(convert_state_dict(sd))


def eval_input():
    return np.random.default_rng(3).standard_normal(SHAPE).astype(
        np.float32)


def jax_calibrated(name, seed=2, **extra):
    """The JAX model (``bn_momentum=1.0``; eval ignores it), seeded weights
    (the port's seeded init carried across by the tools converter: a jitted
    JAX init costs 10-17 s a model here), the same with running stats set
    to one batch's (numpy), and the eval logits of :func:`eval_input` with
    them, the calibration and the eval in one compiled program; cached for
    the file."""
    key = (name, tuple(sorted(extra.items())))
    if key not in _CALIBRATED:
        kw = dict(num_classes=NUM_CLASSES, in_chans=SHAPE[-1], **extra)
        jm = j_create_model(name, bn_momentum=1.0, **kw)
        variables = jax_tree(create_model(name, device="cpu", seed=seed,
                                          **kw).state_dict(), jm)
        xcal = np.random.default_rng(seed).standard_normal(
            CAL_SHAPE).astype(np.float32)

        def calibrate_and_eval(v, xcal, x):
            _, upd = jm.apply(v, xcal, training=True,
                              mutable=["batch_stats"])
            cal = {"params": v["params"], "batch_stats": upd["batch_stats"]}
            return cal, jm.apply(cal, x, training=False)

        cal, ref = jax.jit(calibrate_and_eval)(
            variables, jnp.asarray(xcal), jnp.asarray(eval_input()))
        _CALIBRATED[key] = types.SimpleNamespace(
            jm=jm, variables=variables, calibrated=_np_tree(cal),
            ref=np.asarray(ref))
    return _CALIBRATED[key]


def port_model(name, variables, **extra):
    model = create_model(name, num_classes=NUM_CLASSES, in_chans=SHAPE[-1],
                         device="cpu", **extra)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def check_eval_logits(name, **extra):
    jc = jax_calibrated(name, **extra)
    ref = jc.ref
    # non-degenerate: calibrated logits, not the ~1e-14 of init
    assert np.isfinite(ref).all() and np.abs(ref).max() > 1e-2
    model = port_model(name, jc.calibrated, **extra)
    with torch.inference_mode():
        got = model(_nchw(eval_input())).numpy()
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), (name, err)


def check_round_trip(name, **extra):
    """JAX tree → bridge → port → ``state_dict()`` → the tools converter
    (its CondConv pass for a CondConv model) gives the JAX tree back
    exactly."""
    calibrated = jax_calibrated(name, **extra).calibrated
    sd = port_model(name, calibrated, **extra).state_dict()
    if any(".routing_fn." in k for k in sd):
        back = _convert_condconv(sd, calibrated)
    else:
        back = convert_state_dict(sd)
    want = jax.tree_util.tree_flatten_with_path(calibrated)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want), name
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("name", PATHS)
def test_eval_logits_match_jax(name):
    check_eval_logits(name)


@pytest.mark.parametrize("name,extra", [(n, {}) for n in PATHS] + [
    ("tf_efficientnet_b0", {"global_pool": "catavgmax"})],
    ids=PATHS + ["tf_efficientnet_b0-catavgmax"])
def test_bridge_round_trip_is_exact(name, extra):
    """Each new layout (MixedConv arms, CondConv's flat experts and router,
    EdgeTPU, the 2× catavgmax classifier) and each generator's."""
    check_round_trip(name, **extra)


# ---------------------------------------------------------------------------
# one f32 train step
# ---------------------------------------------------------------------------

def check_train_step(name, ref_dtype="float32"):
    """One rmsproptf step with ``test_torch_train.py``'s clip on soft mixup
    targets from the calibrated weights in both packages: the loss, every
    parameter's update and the BN running stats against the JAX step run
    in ``ref_dtype``.  A model whose first blocks are ReLU takes f64: the
    JAX f32 gradients of mixnet_s's ReLU stem and first block are 2e-3 off
    the JAX f64 ones, which the port's f32 and f64 gradients match to 1e-5
    (and mobilenetv3_large_100's first block drifted past the bound in one
    run of the whole suite); XLA's f64 convolutions are slow on the CPU,
    so the others keep f32 (a CondConv step took 54 s in f64)."""
    ref_dtype = np.dtype(ref_dtype)
    calibrated = jax_calibrated(name).calibrated
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    y = j_mixup.mixup_target_np(rng.integers(0, NUM_CLASSES, SHAPE[0]),
                                NUM_CLASSES, 0.7, 0.1).astype(np.float32)
    jm = j_create_model(name, num_classes=NUM_CLASSES, in_chans=SHAPE[-1])
    tx = j_create_opt(_opt_cfg("rmsproptf"), learning_rate=LR)
    jstep = j_make_step(jm, tx, j_losses.soft_target_cross_entropy,
                        clip_grad=CLIP, donate=False)

    def jax_step(dtype):
        js = j_state(jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                  calibrated), tx, donate=False)
        js, jmet = jstep(js, jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                         jax.random.PRNGKey(0))
        return float(jmet["loss"]), {
            k: v.numpy() for k, v in state_dict_from_flax(_np_tree(
                {"params": js.params,
                 "batch_stats": js.batch_stats})).items()}

    with jax.enable_x64(ref_dtype == np.float64):
        jloss, want = jax_step(ref_dtype)

    model = port_model(name, calibrated)
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


@pytest.mark.parametrize("name,ref_dtype", TRAIN_PATHS)
def test_train_step_matches_jax(name, ref_dtype):
    check_train_step(name, ref_dtype)


# ---------------------------------------------------------------------------
# the trainer's model flags and test-time pooling
# ---------------------------------------------------------------------------

_FLAGS = ["--model", "tf_efficientnet_b7_ns", "--model-version", "",
          "--input-size-v2", "12,600,600"]


def _factory_kwargs(monkeypatch, argv):
    """The keyword arguments each runner's ``build_model`` hands its
    factory for ``argv``."""
    seen = {}

    def capture(which):
        def fake(name, **kw):
            seen[which] = dict(kw, model=name)
            return None
        return fake

    fake = capture("jax")
    monkeypatch.setattr(j_train_runner, "create_model", fake)
    monkeypatch.setitem(j_train_runner._MODEL_FACTORIES, "", fake)
    monkeypatch.setitem(t_train_runner._MODEL_FACTORIES, "",
                        capture("port"))
    j_train_runner.build_model(JTrainConfig.from_args(argv), 12)
    t_train_runner.build_model(t_train_runner.parse_args(argv), "cpu")
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("extra", [
    [], ["--gp", "catavgmax", "--bn-tf", "--drop-block", "0.1"],
    ["--gp", "max"], ["--gp", "avgmax", "--bn-tf"]])
def test_model_flags_match_jax_factory_kwargs(monkeypatch, extra):
    jkw, tkw = _factory_kwargs(monkeypatch, _FLAGS + extra)
    for k in ("model", "global_pool", "bn_tf", "drop_block_rate",
              "num_classes", "in_chans", "drop_rate", "drop_path_rate",
              "bn_momentum", "bn_eps"):
        assert jkw.get(k) == tkw.get(k), (k, jkw.get(k), tkw.get(k))


def test_model_flags_reject_what_the_port_lacks():
    with pytest.raises(SystemExit):
        t_train_runner.parse_args(_FLAGS + ["--gp", "median"])
    with pytest.raises(SystemExit):      # item 6c: --tta waits on item 7.2
        t_train_runner.parse_args(_FLAGS + ["--tta", "1"])


def test_drop_block_warns_as_jax_and_bn_tf_sets_tf_defaults(caplog):
    caplog.set_level(logging.WARNING)
    j_create_model("tf_efficientnet_b0", drop_block_rate=0.1)
    model = create_model("tf_efficientnet_b0", drop_block_rate=0.1,
                         bn_tf=True, device="cpu")
    msgs = [r.getMessage() for r in caplog.records
            if "drop_block_rate" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1], msgs
    assert (model.bn1.eps, model.bn1.momentum) == (1e-3, 0.01)
    # a tf_ name keeps torch's BN defaults when the runner passes
    # bn_tf=False, as the JAX runner's explicit --bn-tf default does
    plain = create_model("tf_efficientnet_b0", bn_tf=False, device="cpu")
    assert (plain.bn1.eps, plain.bn1.momentum) == (1e-5, 0.1)
    assert plain.blocks[1][0].pad_type == "same"


@pytest.mark.parametrize("gp", ["max", "avgmax", "catavgmax"])
def test_global_pool_logits_match_jax(gp):
    """Each ``--gp`` but ``avg`` (the eval test's) on tf_efficientnet_b0
    calibrated with that pool, against the JAX model built with it
    (catavgmax: a 2× classifier)."""
    check_eval_logits("tf_efficientnet_b0", global_pool=gp)
    model = port_model("tf_efficientnet_b0", jax_calibrated(
        "tf_efficientnet_b0", global_pool=gp).calibrated, global_pool=gp)
    assert model.classifier.in_features == \
        model.conv_head.weight.shape[0] * (2 if gp == "catavgmax" else 1)


def test_test_time_pool_matches_jax():
    """``test_time_pool_apply`` on the calibrated tf_efficientnet_b0 at 128²
    (a 4×4 map, 2×2 windows of 3×3) and ``apply_test_time_pool``'s
    decision, against the JAX functions."""
    jc = jax_calibrated("tf_efficientnet_b0")
    jm, calibrated = jc.jm, jc.calibrated
    x = np.random.default_rng(7).standard_normal((2, 128, 128, 12)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: j_ttp.test_time_pool_apply(
        jm, v, x, original_pool=3))(calibrated, jnp.asarray(x)))
    model = port_model("tf_efficientnet_b0", calibrated)
    with torch.inference_mode():
        got = t_ttp.test_time_pool_apply(model, _nchw(x),
                                         original_pool=3).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for size, no_pool in (((3, 300, 300), False), ((3, 300, 300), True),
                          ((3, 224, 224), False), ((3, 300, 200), False)):
        cfg = {"input_size": size}
        assert t_ttp.apply_test_time_pool(model, cfg, no_pool) == \
            j_ttp.apply_test_time_pool(jm, cfg, no_pool), (size, no_pool)


def test_default_cfgs_match_jax():
    from deepfake_detection_tpu.models import efficientnet as j_eff
    from deepfake_detection_tpu_torch.models import efficientnet as t_eff
    assert t_eff.default_cfgs == j_eff.default_cfgs
    for name in list_models(module="efficientnet") + \
            list_models(module="mobilenetv3"):
        assert t_factory.default_cfg(name) == \
            j_create_model(name).default_cfg, name
