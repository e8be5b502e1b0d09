"""PyTorch port, the ResNet family's models against the JAX package on CPU:
eval logits of each distinct path at 64² and 72² (72² gives odd maps,
9 → 5 → 3, for the avg-down shortcut) within 1e-4 of the logit scale, and
the bridge's round trip exact.  The paths of res2net, sknet and SENet, and
the train steps, have their own files, which import the helpers below.

Each path runs at two blocks a stage in both packages (the JAX module
``.clone(layers=...)``, the port's class built from its fields): a stage's
later blocks repeat block 1's construction (``test_torch_resnet_layout.py``
holds every name's full-depth layout), and XLA's compile of a 50-layer
calibration and two evals cost ~5-10 s a path here.

Weights: the port's seeded init, each block's last BN (zero-initialized
by default) set to U(0.1, 0.5) scales, as a trained residual net has small
ones: with unit scales a calibrated random 50-layer net amplifies f32
rounding to 1.6e-4 of its logits (the port's own f32 against its f64, on
resnext50_32x4d at 64²; its f64 matches the JAX package's f64 to 1e-13).
They cross to the JAX module by the tools converter (its generic matcher;
ECA's 1-D kernel handed over as flax's ``(k, 1, 1)``).  BN statistics are
calibrated as ``test_torch_efficientnet_family.py`` does: one JAX
train-mode pass with ``bn_momentum=1.0`` (set by ``.clone``, since the
JAX factory drops that argument for these families) over a batch of 16 at
64² (64 samples a channel at the deepest 2×2), then the eval logits at
both sizes, in one compiled program.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import ResNet, SENet, init_model
from tools.convert_torch_checkpoint import convert_state_dict_generic

torch.set_num_threads(2)

NUM_CLASSES = 2
IN_CHANS = 12
CAL_SHAPE = (16, 64, 64, IN_CHANS)
EVAL_SIZES = (64, 72)
EVAL_BATCH = 4
PATHS = ["resnet18", "resnet26d", "resnext50_32x4d", "seresnext26t_32x4d",
         "ecaresnet50", "gluon_resnet50_v1s"]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _shapes(jm):
    return jax.eval_shape(lambda r: jm.init(
        {"params": r, "dropout": r}, jnp.zeros((1, 32, 32, IN_CHANS)),
        training=False), jax.random.PRNGKey(0))


def jax_tree(sd, jm, shapes=None):
    """A port state dict as the JAX model ``jm``'s variables (numpy), by
    the tools converter's generic matcher against ``jm``'s traced tree;
    ECA's ``(1, 1, k)`` kernel goes as flax's ``(k, 1, 1)``, the one
    layout the matcher does not transpose."""
    sd = {k: (v.permute(2, 1, 0) if v.ndim == 3 else v)
          for k, v in sd.items()}
    return _np_tree(convert_state_dict_generic(sd, shapes or _shapes(jm)))


def port_weights(model):
    """The seeded model with its zero-initialized last BNs at U(0.1, 0.5)
    scales (see the module docstring)."""
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "zero_init", False):
                m.weight.uniform_(0.1, 0.5, generator=g)
    return model


def eval_inputs():
    return [np.random.default_rng(3 + s).standard_normal(
        (EVAL_BATCH, s, s, IN_CHANS)).astype(np.float32) for s in EVAL_SIZES]


_CALIBRATED = {}


def jax_calibrated(key, build_port, build_jax, avg_down=False,
                   small_last_bn=True):
    """``(port model with the calibrated weights, the JAX eval logits at
    each size, the calibrated JAX tree, the JAX module, its shapes)``,
    cached for the file under ``key``; ``small_last_bn=False`` keeps the
    zero-initialized last BNs of the seeded init."""
    key = (key, small_last_bn)
    if key not in _CALIBRATED:
        jm = build_jax()
        shapes = _shapes(jm)
        model = build_port()
        if small_last_bn:
            port_weights(model)
        variables = jax_tree(model.state_dict(), jm, shapes)
        xcal = np.random.default_rng(2).standard_normal(CAL_SHAPE).astype(
            np.float32)

        def calibrate_and_eval(v, xcal, xs):
            _, upd = jm.apply(v, xcal, training=True,
                              mutable=["batch_stats"])
            cal = {"params": v["params"], "batch_stats": upd["batch_stats"]}
            return cal, [jm.apply(cal, x, training=False) for x in xs]

        cal, refs = jax.jit(calibrate_and_eval)(
            variables, jnp.asarray(xcal), [jnp.asarray(x)
                                           for x in eval_inputs()])
        cal = _np_tree(cal)
        model = build_port()
        model.load_state_dict(state_dict_from_flax(cal, avg_down=avg_down),
                              strict=True)
        _CALIBRATED[key] = types.SimpleNamespace(
            model=model, refs=[np.asarray(r) for r in refs], calibrated=cal,
            jm=jm, shapes=shapes, avg_down=avg_down)
    return _CALIBRATED[key]


def port_from_jax(jm):
    """The port's ``ResNet`` or ``SENet`` with the JAX module's fields,
    seeded, on the CPU."""
    cls = {"ResNet": ResNet, "SENet": SENet}[type(jm).__name__]
    names = inspect.signature(cls.__init__).parameters
    return init_model(cls(**{k: getattr(jm, k) for k in names
                             if k != "self" and hasattr(jm, k)}),
                      seed=2, device="cpu")


def by_name(name, **extra):
    """``jax_calibrated``'s arguments for a registered name, at two blocks
    a stage (see the module docstring)."""
    jm = j_create_model(name, num_classes=NUM_CLASSES, in_chans=IN_CHANS,
                        **extra)
    jm = jm.clone(layers=tuple(min(n, 2) for n in jm.layers))
    return dict(key=(name, tuple(sorted(extra.items()))),
                build_port=lambda: port_from_jax(jm),
                build_jax=lambda: jm.clone(bn_momentum=1.0),
                avg_down=bool(getattr(jm, "avg_down", False)))


def check_eval_logits(jc, label):
    for size, x, ref in zip(EVAL_SIZES, eval_inputs(), jc.refs):
        # non-degenerate: calibrated logits, not init's near-zero ones
        assert np.isfinite(ref).all() and np.abs(ref).max() > 1e-2
        with torch.inference_mode():
            got = jc.model(_nchw(x)).numpy()
        err = np.abs(got - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (label, size, err)


def check_round_trip(jc, label):
    """JAX tree → bridge → port → ``state_dict()`` → the tools converter
    gives the JAX tree back exactly."""
    back = jax_tree(jc.model.state_dict(), jc.jm, jc.shapes)
    want = jax.tree_util.tree_flatten_with_path(jc.calibrated)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want), label
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=f"{label} {path}")


@pytest.mark.parametrize("name", PATHS)
def test_eval_logits_match_jax(name):
    check_eval_logits(jax_calibrated(**by_name(name)), name)


@pytest.mark.parametrize("name", PATHS)
def test_bridge_round_trip_is_exact(name):
    check_round_trip(jax_calibrated(**by_name(name)), name)


def test_output_stride_dilation_matches_jax():
    """``output_stride`` 8 (layers 3–4 dilated 2 and 4, unstrided, with
    3×3 shortcuts) on resnet26d's path, and the features / pool-less
    outputs."""
    jc = jax_calibrated(**by_name("resnet18", output_stride=8,
                                  down_kernel_size=3))
    check_eval_logits(jc, "resnet18-os8")
    x = eval_inputs()[0]
    feats = jc.jm.apply(jc.calibrated, jnp.asarray(x), training=False,
                        features_only=True)
    with torch.inference_mode():
        got = jc.model(_nchw(x), features_only=True)
    assert [tuple(f.shape) for f in got] == [
        (f.shape[0], f.shape[3], f.shape[1], f.shape[2]) for f in feats]
    assert got[-1].shape[-1] == got[1].shape[-1]          # no stride after
    for g, f in zip(got, feats):
        f = np.asarray(f).transpose(0, 3, 1, 2)
        assert np.abs(g.numpy() - f).max() <= 1e-4 * np.abs(f).max()
