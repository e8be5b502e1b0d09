"""PyTorch port, ViT and TimeSformer on CPU against the JAX package.

Models: ViT-tiny and TimeSformer-tiny at full depth on 32² inputs, and a
reduced TimeSformer with the base's widths (768 wide, 12 heads of 64) at
patch 8, 12×32², depth 2.  JAX variables (every leaf perturbed with seeded
noise, so LayerNorm scales and biases are not their 1 and 0) cross to the
port with ``convert.state_dict_from_flax``; inputs are seeded numpy, NHWC on
the JAX side and the same memory as NCHW in channels_last on the port's.

* eval logits, ``attn_impl`` full and flash on both sides (the JAX flash
  kernels in interpret mode, the port's on CPU tensors in their plain
  versions), within 1e-4 of the logit scale;
* flash against full inside the port, logits and gradients;
* a clip whose four frames differ pins the frames split (channel
  ``3·f + rgb``): JAX and port agree, and reordering the frames moves the
  logits;
* the ViT round trip port → JAX through
  ``tools/convert_torch_checkpoint.convert_state_dict``: equal logits;
* 1 and 3 guarded train steps of the reduced TimeSformer with flash
  attention (rmsproptf with weight decay, soft mixup targets, clip-grad
  that clips, EMA) against the JAX ``make_train_step``, at 1e-4 of each
  leaf's change (``tests/test_torch_train.py``'s rule; there are no BN
  statistics here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.models.timesformer import (
    TimeSformer as JTimeSformer)
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.optim.rmsprop_tf import RMSpropTFState
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import (TimeSformer, create_model,
                                                 init_model)
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)
REDUCED = dict(patch_size=8, embed_dim=768, depth=2, num_heads=12,
               num_classes=2, in_chans=12)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _jax_model(name, impl):
    if name == "tsf_reduced":
        return JTimeSformer(attn_impl=impl, **REDUCED)
    full = {"vit_tiny": "vit_tiny_patch16_224",
            "tsf_tiny": "timesformer_tiny_patch16_224"}[name]
    chans = 3 if name == "vit_tiny" else 12
    return j_create_model(full, num_classes=2, in_chans=chans,
                          attn_impl=impl)


def _port_model(name, impl):
    if name == "tsf_reduced":
        return init_model(TimeSformer(img_size=32, attn_impl=impl,
                                      **REDUCED), seed=0, device="cpu")
    full = {"vit_tiny": "vit_tiny_patch16_224",
            "tsf_tiny": "timesformer_tiny_patch16_224"}[name]
    chans = 3 if name == "vit_tiny" else 12
    return create_model(full, num_classes=2, in_chans=chans, img_size=32,
                        attn_impl=impl, device="cpu")


HEADS = {"vit_tiny": 3, "tsf_tiny": 3, "tsf_reduced": 12}
SHAPES = {"vit_tiny": (2, 32, 32, 3), "tsf_tiny": (2, 32, 32, 12),
          "tsf_reduced": (2, 32, 32, 12)}


def _variables(name, seed=0):
    """JAX variables of ``name`` with every leaf perturbed by seeded
    noise."""
    model = _jax_model(name, "full")
    v = _np_tree(j_init_model(model, jax.random.PRNGKey(seed),
                              (1,) + SHAPES[name][1:]))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), v)


def _jax_logits(jm, variables, x):
    """Eval logits of a JAX model, as one jitted program."""
    return np.asarray(jax.jit(lambda v, a: jm.apply(v, a, training=False))(
        variables, jnp.asarray(x)))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_logits(model, x):
    with torch.no_grad():
        return model.eval()(_nchw(x)).numpy()


def _close_scale(got, want, rel=1e-4):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def variables():
    return {name: _variables(name) for name in HEADS}


@pytest.mark.parametrize("impl", ["full", "flash"])
@pytest.mark.parametrize("name", list(HEADS))
def test_eval_logits_match_jax(variables, name, impl):
    x = np.random.default_rng(1).standard_normal(SHAPES[name]).astype(
        np.float32)
    want = _jax_logits(_jax_model(name, impl), variables[name], x)
    model = _port_model(name, impl)
    model.load_state_dict(state_dict_from_flax(variables[name],
                                               num_heads=HEADS[name]),
                          strict=True)
    got = _port_logits(model, x)
    assert got.shape == (2, 2)
    _close_scale(got, want)


def test_flash_matches_full_in_the_port(variables):
    """Logits and every parameter's gradient of the reduced TimeSformer in
    train mode, flash against full, same weights and inputs."""
    x = _nchw(np.random.default_rng(2).standard_normal(
        SHAPES["tsf_reduced"]).astype(np.float32))
    sd = state_dict_from_flax(variables["tsf_reduced"], num_heads=12)
    out = {}
    for impl in ("full", "flash"):
        model = _port_model("tsf_reduced", impl)
        model.load_state_dict(sd)
        logits = model.train()(x)
        logits.square().sum().backward()
        out[impl] = (logits.detach().numpy(),
                     {n: p.grad.numpy() for n, p in model.named_parameters()})
    _close_scale(out["flash"][0], out["full"][0], rel=1e-5)
    for n, g in out["full"][1].items():
        _close_scale(out["flash"][1][n], g, rel=1e-4)


def test_distinct_frames_pin_the_frame_split(variables):
    """Four different frames: the port and JAX agree, and swapping two
    frames in the channel axis moves the logits."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    frames = [np.stack([np.sin(xx / (3 + f) + c) + np.cos(yy / (2 + f))
                        for c in range(3)], -1) + 0.1 *
              rng.standard_normal((32, 32, 3)) for f in range(4)]
    clip = np.concatenate(frames, -1)[None].astype(np.float32)  # 3·f + rgb
    swapped = np.concatenate([frames[1], frames[0], *frames[2:]], -1)[
        None].astype(np.float32)
    jm = _jax_model("tsf_tiny", "full")
    model = _port_model("tsf_tiny", "flash")
    model.load_state_dict(state_dict_from_flax(variables["tsf_tiny"],
                                               num_heads=3))
    for x in (clip, swapped):
        _close_scale(_port_logits(model, x),
                     _jax_logits(jm, variables["tsf_tiny"], x))
    moved = np.abs(_port_logits(model, clip)
                   - _port_logits(model, swapped)).max()
    assert moved > 1e-3 * np.abs(_port_logits(model, clip)).max()


def test_vit_round_trip_through_the_jax_converter():
    """Port ViT weights → ``convert_state_dict`` → the JAX model: equal
    logits (the qkv columns permuted both ways)."""
    model = create_model("vit_tiny_patch16_224", num_classes=2, img_size=32,
                         device="cpu", seed=4)
    with torch.no_grad():          # nonzero LayerNorm, biases, class token
        g = torch.Generator().manual_seed(4)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    variables = convert_state_dict(model.state_dict(), num_heads=3)
    jm = j_create_model("vit_tiny_patch16_224", num_classes=2)
    want = _jax_logits(jm, {"params": variables["params"]}, x)
    _close_scale(_port_logits(model, x), want)
    # and back: the port's converter inverts the tool's
    back = state_dict_from_flax(variables, num_heads=3)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

LR, CLIP, EMA_DECAY, WD, STEPS = 0.01, 0.5, 0.9, 1e-2, 3


def _opt_cfg():
    import types
    return types.SimpleNamespace(opt="rmsproptf", opt_eps=1e-8, momentum=0.9,
                                 weight_decay=WD)


def _leaves(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": _np_tree(tree)}, num_heads=12).items()}


@pytest.fixture(scope="module")
def train_run(variables):
    """The same three guarded steps of the reduced TimeSformer with flash
    attention in both packages; per-step snapshots as port-named numpy."""
    v0 = variables["tsf_reduced"]
    rng = np.random.default_rng(5)
    batches = []
    for i in range(STEPS):
        x = rng.standard_normal(SHAPES["tsf_reduced"]).astype(np.float32)
        labels = rng.integers(0, 2, x.shape[0])
        y = j_mixup.mixup_target_np(labels, 2, 0.6 + 0.1 * i, 0.1).astype(
            np.float32)
        batches.append((x, y))

    jm = _jax_model("tsf_reduced", "flash")
    tx = j_create_opt(_opt_cfg(), learning_rate=LR)
    jstep = j_make_step(jm, tx, j_losses.soft_target_cross_entropy,
                        ema_decay=EMA_DECAY, clip_grad=CLIP,
                        nonfinite_guard=True, donate=False)
    js = j_state(jax.tree.map(jnp.asarray, v0), tx, with_ema=True,
                 donate=False)

    def jsnap(js):
        rms = [s for s in jax.tree.leaves(
            js.opt_state, is_leaf=lambda n: isinstance(n, RMSpropTFState))
            if isinstance(s, RMSpropTFState)][0]
        return {"model": _leaves(js.params), "ema": _leaves(js.ema["params"]),
                "square_avg": _leaves(rms.square_avg),
                "momentum": _leaves(rms.momentum_buffer),
                "step": int(js.step)}

    j_snaps, j_met = [jsnap(js)], []
    key = jax.random.PRNGKey(0)
    for x, y in batches:
        js, m = jstep(js, jnp.asarray(x), jnp.asarray(y), key)
        j_snaps.append(jsnap(js))
        j_met.append({k: float(v) for k, v in m.items()})

    model = _port_model("tsf_reduced", "flash")
    model.load_state_dict(state_dict_from_flax(v0, num_heads=12))
    ts = create_train_state(model, create_optimizer(_opt_cfg(), model, LR),
                            with_ema=True, ema_decay=EMA_DECAY)
    names = {id(p): n for n, p in model.named_parameters()}

    def tsnap(ts):
        out = {"model": {k: v.detach().numpy().copy()
                         for k, v in ts.model.state_dict().items()},
               "ema": {k: v.detach().numpy().copy()
                       for k, v in ts.ema.state_dict().items()},
               "square_avg": {}, "momentum": {}, "step": int(ts.step)}
        for p, st in ts.optimizer.state.items():
            out["square_avg"][names[id(p)]] = st["square_avg"].numpy().copy()
            out["momentum"][names[id(p)]] = \
                st["momentum_buffer"].numpy().copy()
        return out

    tstep = make_train_step(t_losses.soft_target_cross_entropy,
                            clip_grad=CLIP, nonfinite_guard=True)
    t_snaps, t_met = [tsnap(ts)], []
    for x, y in batches:
        m = tstep(ts, _nchw(x), torch.from_numpy(y))
        t_snaps.append(tsnap(ts))
        t_met.append({k: float(v) for k, v in m.items()})
    return dict(j=j_snaps, t=t_snaps, jm=j_met, tm=t_met)


def test_train_step_metrics_match_jax(train_run):
    for tm, jm in zip(train_run["tm"], train_run["jm"]):
        for k in ("loss", "gnorm"):
            assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)
        assert tm["prec1"] == jm["prec1"]
        assert tm["nonfinite"] == jm["nonfinite"] == 0.0
    assert train_run["tm"][0]["gnorm"] == pytest.approx(CLIP, rel=1e-5), \
        "the test's clip threshold must clip"


@pytest.mark.parametrize("after", [1, STEPS])
def test_train_state_matches_jax(train_run, after):
    """Params, RMSprop moments and the EMA after ``after`` steps, each
    within 1e-4 of its own change plus 2 f32 ulps a step."""
    t, j = train_run["t"][after], train_run["j"][after]
    t0, j0 = train_run["t"][0], train_run["j"][0]
    assert t["step"] == j["step"] == after
    for part in ("model", "ema", "square_avg", "momentum"):
        assert set(t[part]) == set(j[part]), part
        for k in j[part]:
            if part == "model":
                np.testing.assert_array_equal(t0[part][k], j0[part][k])
            got, want, init = (np.asarray(a, np.float64) for a in
                               (t[part][k], j[part][k], j0[part][k]))
            err = np.abs(got - want).max()
            bound = 1e-4 * np.abs(want - init).max() \
                + 2 * after * EPS32 * np.abs(want).max()
            assert err <= bound, (part, k, err, bound)
        assert any(np.any(t[part][k] != t0[part][k]) for k in t[part]), part
