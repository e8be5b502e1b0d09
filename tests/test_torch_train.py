"""PyTorch port, the training slice on CPU against the JAX package.

Units: ``RMSpropTF`` and the optimizer factory (rmsproptf, rmsprop, sgd
with the weight-decay mask), the losses, mixup, the schedules, the EMA,
the metrics and ``SyntheticDataset``, each against its JAX counterpart on
the same seeded numpy inputs.

The slice as a whole: the reduced flagship (``efficientnet_deepfake_v4`` at
a quarter width and 10 blocks, as ``test_torch_efficientnet.py``) at
12×64², batch 4, with BN calibrated by one JAX train-mode pass and carried
across by ``convert.state_dict_from_flax``.  Three steps of the port's
``make_train_step`` (rmsproptf, soft-target CE on fixed mixup targets,
clip-grad that clips, EMA, the non-finite guard) against the JAX
``make_train_step`` of the same model with ``fused_depthwise="off"`` (its
XLA composition; the Pallas kernel cannot be traced by this jax version),
compared after step 1 and step 3: loss, the clipped gradients, the
parameter updates, BN running stats, RMSprop ``square_avg`` and momentum
buffers, and the EMA.  JAX's optimizer and EMA trees have the params'
structure, so they cross by the same converter.  Then one
``train_one_epoch`` over the same list of batches in both packages.

Tolerances (measured maxima in the comments):

* loss and gradient norm: 1e-5 relative;
* gradients: 1e-4 of each leaf's max |g|, plus 1e-7 of the clipped
  global norm for leaves whose gradient cancels to rounding noise (a BN
  bias that feeds straight into the next BN: ~1e-9, off by ~4e-9);
* every leaf that starts from a known value (params, moments, EMA): the
  difference within 1e-4 of that leaf's own change over the run, plus 2
  f32 ulps of the leaf's magnitude per step, because each step stores a
  rounded f32 and the change can be a few ulps of it (the EMA after 3
  steps: 3 ulps measured), plus lr × that gradient floor × steps for the
  leaves whose gradient is rounding noise;
* BN running stats, of the model and of the EMA: as
  ``test_train_mode_calibration_matches_jax`` (mean against the channel
  spread, var against the spread²), 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import dataset as j_dataset
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.optim.rmsprop_tf import RMSpropTFState
from deepfake_detection_tpu.scheduler import schedules as j_sched
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu.train import train_one_epoch as j_epoch
from deepfake_detection_tpu.train.steps import _clip_grads as j_clip
from deepfake_detection_tpu.utils import ema as j_ema
from deepfake_detection_tpu.utils import metrics as j_metrics
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.data import dataset as t_dataset
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.ops import BatchNorm2d
from deepfake_detection_tpu_torch.optim import RMSpropTF
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.scheduler import schedules as t_sched
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from deepfake_detection_tpu_torch.train.trainer import train_one_epoch
from deepfake_detection_tpu_torch.utils import metrics as t_metrics
from deepfake_detection_tpu_torch.utils.ema import ModelEma

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _opt_cfg(opt, wd=1e-5):
    return types.SimpleNamespace(opt=opt, opt_eps=1e-8, momentum=0.9,
                                 weight_decay=wd)


def _close_change(got, want, init, name, rel=1e-4, floor=0.0, steps=1):
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    err = np.abs(got - want).max()
    bound = rel * np.abs(want - init).max() \
        + 2 * steps * EPS32 * np.abs(want).max() + floor
    assert err <= bound, (name, err, bound)
    return err


def _close_rel(got, want, name, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err)
    return err


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

_PSHAPES = {"conv": (3, 3, 2, 4), "dense": (5, 3), "bias": (3,)}


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("opt", ["rmsproptf", "rmsprop", "sgd"])
def test_optimizer_factory_matches_jax(opt, wd):
    """Four steps of the port's optimizer against the JAX factory's optax
    chain on the same gradients, with a changing lr between steps (the
    scheduler's rewrite): params and, for RMSprop, both moments."""
    rng = np.random.default_rng(len(opt) + int(wd * 100))
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in _PSHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in _PSHAPES.items()} for _ in range(4)]
    lrs = [0.1, 0.1, 0.05, 0.02]
    tx = j_create_opt(_opt_cfg(opt, wd), learning_rate=lrs[0])
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    model = _Params(params)
    topt = create_optimizer(_opt_cfg(opt, wd), model, lrs[0])
    for g, lr in zip(grads, lrs):
        st.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for group in topt.param_groups:
            group["lr"] = lr
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k, p in model.named_parameters():
        _close_change(p.detach().numpy(), jp[k], params[k], k)
    if opt.startswith("rmsprop"):
        jstate = [s for s in jax.tree.leaves(
            st.inner_state, is_leaf=lambda n: isinstance(n, RMSpropTFState))
            if isinstance(s, RMSpropTFState)]
        for k, p in model.named_parameters():
            if jstate:
                _close_rel(topt.state[p]["square_avg"].numpy(),
                           jstate[0].square_avg[k], f"{k} square_avg")
                _close_rel(topt.state[p]["momentum_buffer"].numpy(),
                           jstate[0].momentum_buffer[k], f"{k} momentum")


def test_rmsproptf_semantics():
    """Accumulator at ones, eps inside the sqrt, lr folded into momentum,
    coupled weight decay: one step by hand."""
    p = torch.nn.Parameter(torch.tensor([2.0]))
    opt = RMSpropTF([p], lr=0.5, alpha=0.9, eps=0.01, weight_decay=0.1,
                    momentum=0.9)
    assert float(opt.state[p]["square_avg"]) == 1.0
    p.grad = torch.tensor([3.0])
    opt.step()
    g = 3.0 + 0.1 * 2.0
    sq = 1.0 + 0.1 * (g * g - 1.0)
    buf = 0.5 * g / np.sqrt(sq + 0.01)
    assert np.isclose(float(opt.state[p]["square_avg"]), sq, rtol=1e-6)
    assert np.isclose(float(opt.state[p]["momentum_buffer"]), buf, rtol=1e-6)
    assert np.isclose(float(p.detach()), 2.0 - buf, rtol=1e-6)


def test_optimizer_factory_masks_weight_decay_and_rejects_unported():
    model = _Params({k: np.zeros(s, np.float32) for k, s in _PSHAPES.items()})
    opt = create_optimizer(_opt_cfg("rmsproptf", 1e-5), model, 0.1)
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"]
               for p in g["params"]}
    assert decayed == {id(model.conv), id(model.dense)}
    # every name of the JAX factory is ported; only an unknown one raises
    create_optimizer(_opt_cfg("adamw"), model, 0.1)
    for name in ("momentum", "fusedmomentum", "lookahead_adagrad"):
        with pytest.raises(ValueError, match="Invalid optimizer"):
            create_optimizer(_opt_cfg(name), model, 0.1)


# ---------------------------------------------------------------------------
# losses, metrics, mixup, schedules, EMA, dataset
# ---------------------------------------------------------------------------

def _logits_and_targets(seed=0, b=6, c=3):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, b)
    soft = j_mixup.mixup_target_np(labels, c, 0.7, 0.1).astype(np.float32)
    weight = (rng.random(b) > 0.3).astype(np.float32)
    return logits, labels, soft, weight


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    logits, labels, soft, weight = _logits_and_targets()
    w_j = jnp.asarray(weight) if masked else None
    w_t = torch.from_numpy(weight) if masked else None
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    pairs = [
        (t_losses.cross_entropy(tl, tlab, w_t),
         j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                w_j)),
        (t_losses.label_smoothing_cross_entropy(tl, tlab, 0.1, w_t),
         j_losses.label_smoothing_cross_entropy(
             jnp.asarray(logits), jnp.asarray(labels), 0.1, w_j)),
        (t_losses.soft_target_cross_entropy(tl, torch.from_numpy(soft), w_t),
         j_losses.soft_target_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(soft), w_j))]
    for got, want in pairs:
        _close_rel(got.numpy(), want, "loss", rel=1e-6)
    assert t_metrics.accuracy(tl, tlab, weight=w_t).numpy() == pytest.approx(
        float(j_metrics.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                 weight=w_j)))
    _close_rel(t_metrics.masked_mean(tl[:, 0], w_t).numpy(),
               j_metrics.masked_mean(jnp.asarray(logits[:, 0]), w_j), "mean")


def test_jsd_and_loss_precedence_match_jax():
    logits, labels, soft, _ = _logits_and_targets(1, b=6)
    _close_rel(t_losses.jsd_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels)).numpy(),
               j_losses.jsd_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)), "jsd",
               rel=1e-6)
    for cfg, want in [
            (dict(mixup=0.1, smoothing=0.1), "soft_target_cross_entropy"),
            (dict(mixup=0.0, smoothing=0.1), None),
            (dict(mixup=0.0, smoothing=0.0), "cross_entropy")]:
        ns = types.SimpleNamespace(**cfg)
        fn_t, fn_j = t_losses.create_loss_fn(ns), j_losses.create_loss_fn(ns)
        if want is not None:
            assert fn_t.__name__ == fn_j.__name__ == want
        target = soft if cfg["mixup"] else labels
        _close_rel(fn_t(torch.from_numpy(logits),
                        torch.from_numpy(target)).numpy(),
                   fn_j(jnp.asarray(logits), jnp.asarray(target)), "loss",
                   rel=1e-6)


def test_collate_mixup_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (4, 6, 5, 12), dtype=np.uint8)
    labels = np.array([0, 1, 1, 0])
    got = t_mixup.FastCollateMixup(0.1, 0.1, 2)(
        images, labels, np.random.default_rng(9))
    want = j_mixup.FastCollateMixup(0.1, 0.1, 2)(
        images, labels, np.random.default_rng(9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mixup_batch_matches_jax_at_its_lambda():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 3, 6)).astype(np.float32)
    y = np.array([1, 0, 0, 1])
    key = jax.random.PRNGKey(5)
    want_x, want_y = j_mixup.mixup_batch(jnp.asarray(x), jnp.asarray(y), key,
                                         alpha=0.2, num_classes=2)
    lam = float(jax.random.beta(key, 0.2, 0.2))
    got_x, got_y = t_mixup.mixup_batch(torch.from_numpy(x),
                                       torch.from_numpy(y), alpha=0.2,
                                       num_classes=2, lam=lam)
    _close_rel(got_x.numpy(), want_x, "x", rel=1e-6)
    _close_rel(got_y.numpy(), want_y, "y", rel=1e-6)
    # drawn on an explicit generator: reproducible, in (0, 1)
    a = t_mixup.mixup_batch(torch.from_numpy(x), torch.from_numpy(y),
                            torch.Generator().manual_seed(1), num_classes=2)
    b = t_mixup.mixup_batch(torch.from_numpy(x), torch.from_numpy(y),
                            torch.Generator().manual_seed(1), num_classes=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name,kw", [
    ("StepSchedule", dict(decay_t=2, decay_rate=0.92, warmup_t=1,
                          warmup_lr_init=1e-4)),
    ("CosineSchedule", dict(t_initial=10, lr_min=1e-5, warmup_t=2,
                            warmup_lr_init=1e-4, cycle_limit=1)),
    ("TanhSchedule", dict(t_initial=10, lr_min=1e-5, cycle_limit=1)),
    ("StepSchedule", dict(decay_t=3, decay_rate=0.5,
                          noise_range_t=(2, 8)))])
def test_schedules_match_jax(name, kw):
    a = getattr(t_sched, name)(0.01, **kw)
    b = getattr(j_sched, name)(0.01, **kw)
    for t in range(15):
        assert a.step(t) == b.step(t)
        assert a.step_update(t * 7) == b.step_update(t * 7)


def test_plateau_schedule_matches_jax():
    a = t_sched.PlateauSchedule(0.1, decay_rate=0.5, patience_t=1,
                                cooldown_t=1)
    b = j_sched.PlateauSchedule(0.1, decay_rate=0.5, patience_t=1,
                                cooldown_t=1)
    for epoch, metric in enumerate([1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6,
                                    0.7, 0.8]):
        assert a.step(epoch, metric) == b.step(epoch, metric)


def test_ema_matches_jax_and_copies_int_buffers():
    """The EMA over params and BN running stats, decay 0.9998 and 0.5;
    ``num_batches_tracked`` is copied, not averaged."""
    rng = np.random.default_rng(6)
    bn = BatchNorm2d(5)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(
                np.float32)))
    for decay in (0.9998, 0.5):
        ema = ModelEma(bn, decay)
        init = {k: v.clone() for k, v in ema.state_dict().items()}
        jtree = {k: jnp.asarray(v.numpy()) for k, v in init.items()
                 if v.is_floating_point()}
        for step in range(3):
            with torch.no_grad():
                for t in (bn.weight, bn.bias, bn.running_mean,
                          bn.running_var):
                    t.add_(torch.from_numpy(rng.standard_normal(5).astype(
                        np.float32)))
                bn.num_batches_tracked.add_(1)
            ema.update(bn)
            jtree = j_ema.update_ema(
                jtree, {k: jnp.asarray(v.numpy()) for k, v in
                        bn.state_dict().items() if v.is_floating_point()},
                decay)
        for k, v in ema.state_dict().items():
            if v.is_floating_point():
                _close_change(v.numpy(), jtree[k], init[k].numpy(), k)
            else:
                assert int(v) == int(bn.num_batches_tracked)
        assert not any(p.requires_grad for p in ema.module.parameters())


def test_synthetic_dataset_is_bit_identical_to_jax():
    a = t_dataset.SyntheticDataset(6, (9, 7, 12), 2, seed=5)
    b = j_dataset.SyntheticDataset(6, (9, 7, 12), 2, seed=5)
    assert len(a) == len(b)
    for i in range(len(a)):
        np.testing.assert_array_equal(a[i][0], b[i][0])
        assert a[i][1] == b[i][1]


# ---------------------------------------------------------------------------
# the slice: make_train_step on the reduced flagship
# ---------------------------------------------------------------------------

MODEL = "efficientnet_deepfake_v4"
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.34)
SHAPE = (4, 64, 64, 12)
LR, CLIP, EMA_DECAY, BN_MOMENTUM, STEPS = 0.02, 0.5, 0.9, 0.1, 3
GRAD_FLOOR = 1e-7 * CLIP            # see the module docstring
STATE_FLOOR = LR * GRAD_FLOOR * STEPS


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def slice_run():
    """The same three steps in both packages; returns the initial and
    per-step snapshots of each, as timm-named numpy dicts."""
    jcal = j_create_model(MODEL, bn_momentum=1.0, **KW)
    v0 = j_init_model(jcal, jax.random.PRNGKey(2), SHAPE)
    rng = np.random.default_rng(2)
    xcal = rng.standard_normal(SHAPE).astype(np.float32)
    _, upd = jax.jit(lambda v, x: jcal.apply(
        v, x, training=True, mutable=["batch_stats"]))(v0, jnp.asarray(xcal))
    calibrated = _np_tree({"params": v0["params"],
                           "batch_stats": upd["batch_stats"]})
    batches = []
    for i in range(STEPS):
        x = rng.standard_normal(SHAPE).astype(np.float32)
        labels = rng.integers(0, 2, SHAPE[0])
        y = j_mixup.mixup_target_np(labels, 2, 0.6 + 0.1 * i, 0.1).astype(
            np.float32)
        batches.append((x, y))

    # JAX: the package's own train step over its XLA depthwise
    jm = j_create_model(MODEL, bn_momentum=BN_MOMENTUM, **KW)
    tx = j_create_opt(_opt_cfg("rmsproptf"), learning_rate=LR)
    jstep = j_make_step(jm, tx, j_losses.soft_target_cross_entropy,
                        ema_decay=EMA_DECAY, clip_grad=CLIP,
                        nonfinite_guard=True, donate=False)
    key = jax.random.PRNGKey(0)
    js = j_state(jax.tree.map(jnp.asarray, calibrated), tx, with_ema=True,
                 donate=False)
    j_snaps, j_metrics_ = [_jax_snapshot(js)], []
    state0 = js
    for x, y in batches:
        js, m = jstep(js, jnp.asarray(x), jnp.asarray(y), key)
        j_snaps.append(_jax_snapshot(js))
        j_metrics_.append({k: float(v) for k, v in m.items()})

    def lossf(p):
        logits, _ = jm.apply({"params": p,
                              "batch_stats": state0.batch_stats},
                             jnp.asarray(batches[0][0]), training=True,
                             mutable=["batch_stats"], rngs={"dropout": key})
        return j_losses.soft_target_cross_entropy(logits,
                                                  jnp.asarray(batches[0][1]))
    jgrads = state_dict_from_flax({"params": _np_tree(
        j_clip(jax.jit(jax.grad(lossf))(state0.params), CLIP))})

    # port
    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM, **KW)
    model.load_state_dict(state_dict_from_flax(calibrated), strict=True)
    ts = create_train_state(model, create_optimizer(_opt_cfg("rmsproptf"),
                                                    model, LR),
                            with_ema=True, ema_decay=EMA_DECAY)
    tstep = make_train_step(t_losses.soft_target_cross_entropy,
                            clip_grad=CLIP, nonfinite_guard=True)
    t_snaps, t_metrics_, tgrads = [_port_snapshot(ts)], [], None
    for x, y in batches:
        m = tstep(ts, torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(y))
        t_snaps.append(_port_snapshot(ts))
        t_metrics_.append({k: float(v) for k, v in m.items()})
        if tgrads is None:
            tgrads = {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()}
    return dict(j=j_snaps, t=t_snaps, jm=j_metrics_, tm=t_metrics_,
                jgrads=jgrads, tgrads=tgrads, batches=batches,
                calibrated=calibrated, jstep=jstep, tx=tx, key=key)


def _param_leaves(tree):
    """A params-structured JAX tree → {timm name: array}, parameters only
    (the converter also adds BN counters)."""
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": _np_tree(tree)}).items()
        if not k.endswith("num_batches_tracked")}


def _jax_snapshot(js):
    rms = [s for s in jax.tree.leaves(
        js.opt_state, is_leaf=lambda n: isinstance(n, RMSpropTFState))
        if isinstance(s, RMSpropTFState)][0]
    ema = state_dict_from_flax(_np_tree(js.ema))
    return {"model": {k: v.numpy() for k, v in state_dict_from_flax(
                _np_tree({"params": js.params,
                          "batch_stats": js.batch_stats})).items()},
            "square_avg": _param_leaves(rms.square_avg),
            "momentum": _param_leaves(rms.momentum_buffer),
            "ema": {k: v.numpy() for k, v in ema.items()},
            "step": int(js.step)}


def _port_snapshot(ts):
    names = {id(p): n for n, p in ts.model.named_parameters()}
    out = {"model": {k: v.detach().numpy().copy()
                     for k, v in ts.model.state_dict().items()},
           "ema": {k: v.detach().numpy().copy()
                   for k, v in ts.ema.state_dict().items()},
           "square_avg": {}, "momentum": {}, "step": int(ts.step)}
    for p, st in ts.optimizer.state.items():
        out["square_avg"][names[id(p)]] = st["square_avg"].numpy().copy()
        out["momentum"][names[id(p)]] = st["momentum_buffer"].numpy().copy()
    return out


def _bn_stats_close(got, want):
    """Running stats against their own scale, as in
    ``test_train_mode_calibration_matches_jax``: a mean against the channel
    spread sqrt(var), a var against var."""
    for k in want:
        if k.endswith("running_var"):
            base = k[:-len("running_var")]
            spread = np.sqrt(want[k].max())
            for leaf, scale in (("running_mean", spread),
                                ("running_var", spread ** 2)):
                diff = np.abs(got[base + leaf] - want[base + leaf]).max()
                assert diff <= 1e-4 * scale, (base + leaf, diff, scale)


def test_slice_loss_and_gradients_match_jax(slice_run):
    for i, (tm, jm) in enumerate(zip(slice_run["tm"], slice_run["jm"])):
        _close_rel(tm["loss"], jm["loss"], f"loss step {i}", rel=1e-5)
        _close_rel(tm["gnorm"], jm["gnorm"], f"gnorm step {i}", rel=1e-5)
        assert tm["prec1"] == jm["prec1"]
        assert tm["nonfinite"] == jm["nonfinite"] == 0.0
    assert slice_run["tm"][0]["gnorm"] == pytest.approx(CLIP, rel=1e-5), \
        "the test's clip threshold must clip"
    for k, g in slice_run["tgrads"].items():
        want = slice_run["jgrads"][k].numpy()
        err = np.abs(g - want).max()
        assert err <= 1e-4 * np.abs(want).max() + GRAD_FLOOR, (k, err)


@pytest.mark.parametrize("after", [1, STEPS])
def test_slice_state_matches_jax(slice_run, after):
    """Params (as updates), BN running stats, RMSprop moments and the EMA
    after ``after`` steps."""
    t, j = slice_run["t"][after], slice_run["j"][after]
    t0, j0 = slice_run["t"][0], slice_run["j"][0]
    assert t["step"] == j["step"] == after
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k in j["model"]:
        if k.endswith("num_batches_tracked"):     # the port's BN counts
            assert t["model"][k] == t["ema"][k] == after, k
    model_w = {k for k in j["model"] if not k.endswith(stats)}
    for k in model_w:
        np.testing.assert_array_equal(t0["model"][k], j0["model"][k])
        _close_change(t["model"][k], j["model"][k], j0["model"][k], k,
                      floor=STATE_FLOOR, steps=after)
    _bn_stats_close(t["model"], j["model"])
    _bn_stats_close(t["ema"], j["ema"])
    for part in ("square_avg", "momentum"):
        assert set(t[part]) == set(j[part])
        for k in j[part]:
            _close_change(t[part][k], j[part][k], j0[part][k], f"{part} {k}",
                          floor=STATE_FLOOR, steps=after)
    for k in j["ema"]:
        if not k.endswith(stats):
            _close_change(t["ema"][k], j["ema"][k], j0["ema"][k], f"ema {k}",
                          floor=STATE_FLOOR, steps=after)
    # something moved in every part of the state
    for part in ("square_avg", "momentum", "ema"):
        assert any(np.any(t[part][k] != t0[part][k]) for k in t[part]), part


def test_train_one_epoch_matches_jax(slice_run):
    """``train_one_epoch`` over the same list of batches in both packages,
    from the calibrated weights: the epoch's averaged loss and top-1 and the
    final params."""
    cfg = types.SimpleNamespace(mixup=0.1, mixup_off_epoch=0, log_interval=2,
                                recovery_interval=0, save_images=False,
                                profile=0)
    batches = slice_run["batches"]
    js = j_state(jax.tree.map(jnp.asarray, slice_run["calibrated"]),
                 slice_run["tx"], with_ema=True, donate=False)
    js, jmet = j_epoch(0, slice_run["jstep"], js,
                       [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches],
                       cfg, slice_run["key"])
    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM, **KW)
    model.load_state_dict(state_dict_from_flax(slice_run["calibrated"]))
    ts = create_train_state(model, create_optimizer(_opt_cfg("rmsproptf"),
                                                    model, LR),
                            with_ema=True, ema_decay=EMA_DECAY)
    ts, tmet = train_one_epoch(
        0, make_train_step(t_losses.soft_target_cross_entropy,
                           clip_grad=CLIP, nonfinite_guard=True), ts,
        [(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y))
         for x, y in batches], cfg)
    _close_rel(tmet["loss"], jmet["loss"], "epoch loss", rel=1e-5)
    assert tmet["prec1"] == pytest.approx(jmet["prec1"])
    assert tmet["nonfinite"] == jmet["nonfinite"] == 0
    assert len(tmet["step_s"]) == len(batches)
    got = _port_snapshot(ts)["model"]
    want = slice_run["j"][STEPS]["model"]
    init = slice_run["j"][0]["model"]
    for k in want:
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            _close_change(got[k], want[k], init[k], k, floor=STATE_FLOOR,
                          steps=STEPS)
