"""PyTorch port, AdvProp split BN (``--split-bn``) on CPU against the JAX
package.

* ``ops.norm.SplitBatchNorm2d`` against the JAX ``SplitBatchNorm2d`` (3
  splits, torch-convention momentum 0.1, seeded perturbed parameters and
  running stats): the train-mode output and every BN's running stats after
  two steps, and the eval output (the main BN alone), within 1e-5 of each
  quantity's scale;
* the weight bridge: a split-BN flax tree maps onto timm's layout (the
  main BN under the module's own name, ``aux_bn.<i>`` for aux ``i``) and
  loads strictly;
* a small split3 EfficientNet (the flagship at a quarter width and its
  first stages, 12×64², batch 6) with BN calibrated by one JAX train-mode
  pass, carried across the bridge: eval logits within 1e-5 of the logit
  scale; one JSD train step (``--compute-dtype float32`` on both sides:
  the JAX ``make_train_step`` over its XLA depthwise, the port's over its
  kernels' plain versions) by ``tests/test_torch_train.py``'s method: the
  loss at 1e-5 relative, every parameter's update within 1e-4 of its own
  change, and every BN's running stats (main and aux) at 1e-4 of their
  scale, the aux stats differing from the main's; the same step in bf16
  (the JAX runner's default compute dtype) by ``tests/test_torch_amp.py``'s
  tolerance method, on bounds twice the values measured here;
* the runner: ``--split-bn`` builds split BN everywhere; the flag errors
  are the JAX runner's (``--split-bn`` without ``--aug-splits > 1`` or
  ``--resplit``, ``--jsd`` without aug splits, aug splits with the mixup
  collate); a CPU run of ``runners.train`` with ``--aug-splits 3 --jsd
  --split-bn`` moves the main and aux stats apart, and the checkpoint
  carries the aux BNs for the model and the EMA and resumes strictly.

The JAX runner itself cannot build a split-BN model (its init traces the
model in train mode at batch 1, which no split divides: ROADMAP Queue 3),
so the tests drive the JAX modules and ``make_train_step`` directly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.data import dataset as j_dataset
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.ops.norm import SplitBatchNorm2d as JSplitBN
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.runners import train as j_runner
from deepfake_detection_tpu import config as j_config
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import (flax_leaf,
                                                  state_dict_from_flax)
from deepfake_detection_tpu_torch.data import dataset as t_dataset
from deepfake_detection_tpu_torch.data import loader as t_loader
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.ops import BatchNorm2d, SplitBatchNorm2d
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from test_torch_train import _close_change, _close_rel

torch.set_num_threads(2)

SPLITS = 3


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _perturbed_bn_tree(rng, c):
    bn = lambda: {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                  "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    st = lambda: {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                  "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    names = ["main"] + [f"aux{i}" for i in range(SPLITS - 1)]
    return ({n: {"bn": bn()} for n in names},
            {n: {"bn": st()} for n in names})


def _port_split_bn(params, stats, c):
    m = SplitBatchNorm2d(c, momentum=0.1, eps=1e-5, num_splits=SPLITS)
    sd = {}
    for n in params:
        base = "" if n == "main" else f"aux_bn.{n[3:]}."
        sd[base + "weight"] = params[n]["bn"]["scale"]
        sd[base + "bias"] = params[n]["bn"]["bias"]
        sd[base + "running_mean"] = stats[n]["bn"]["mean"]
        sd[base + "running_var"] = stats[n]["bn"]["var"]
        sd[base + "num_batches_tracked"] = np.int64(0)
    m.load_state_dict({k: torch.as_tensor(np.asarray(v))
                       for k, v in sd.items()}, strict=True)
    return m


def _close_scale(got, want, name, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err)
    return err


def test_split_batchnorm_matches_jax_in_train_and_eval():
    rng = np.random.default_rng(0)
    c, b = 5, 2 * SPLITS
    params, stats = _perturbed_bn_tree(rng, c)
    jm = JSplitBN(num_splits=SPLITS, momentum=0.1, eps=1e-5)
    tm = _port_split_bn(params, stats, c).train()
    variables = {"params": params, "batch_stats": stats}
    for step in range(2):
        # each split its own offset and scale, so the splits' stats differ
        x = (rng.standard_normal((b, 4, 3, c))
             * np.repeat(np.arange(1, SPLITS + 1), b // SPLITS)[:, None,
                                                               None, None]
             + np.repeat(np.arange(SPLITS), b // SPLITS)[:, None, None,
                                                         None]
             ).astype(np.float32)
        yj, upd = jm.apply(variables, jnp.asarray(x), training=True,
                           mutable=["batch_stats"])
        variables = {"params": params, "batch_stats": upd["batch_stats"]}
        yt = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        _close_scale(yt.permute(0, 2, 3, 1).detach().numpy(), yj,
                     f"train output, step {step}")
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    for n, leaves in variables["batch_stats"].items():
        base = "" if n == "main" else f"aux_bn.{n[3:]}."
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            _close_scale(got[base + key], leaves["bn"][leaf], base + key)
        assert got[base + "num_batches_tracked"] == 2
    # the splits' stats differ
    assert np.abs(got["running_mean"] - got["aux_bn.1.running_mean"]).max() \
        > 0.1
    tm.eval()
    x = rng.standard_normal((b, 4, 3, c)).astype(np.float32)
    yj = jm.apply(variables, jnp.asarray(x), training=False)
    yt = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close_scale(yt.permute(0, 2, 3, 1).detach().numpy(), yj, "eval output")
    # eval reads the main BN alone: it is a plain BatchNorm2d's output
    plain = BatchNorm2d(c, momentum=0.1, eps=1e-5).eval()
    plain.load_state_dict({k: v for k, v in tm.state_dict().items()
                           if "aux_bn" not in k})
    torch.testing.assert_close(plain(torch.from_numpy(x).permute(0, 3, 1, 2)),
                               yt, rtol=0, atol=0)


def test_split_batchnorm_rejects_an_uneven_batch():
    m = SplitBatchNorm2d(4, num_splits=3).train()
    with pytest.raises(ValueError, match="equal splits"):
        m(torch.zeros(4, 4, 2, 2))
    with pytest.raises(ValueError, match="num_splits"):
        SplitBatchNorm2d(4, num_splits=1)


# ---------------------------------------------------------------------------
# a small split3 EfficientNet
# ---------------------------------------------------------------------------

MODEL = "efficientnet_deepfake_v4"
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.1)
SHAPE = (2 * SPLITS, 64, 64, 12)
LR, BN_MOMENTUM = 0.02, 0.1


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def split_model():
    """A JAX split3 model calibrated by one train-mode pass (each split's
    BN set to its rows' statistics), and the port's copy of it."""
    jcal = j_create_model(MODEL, bn_momentum=1.0, norm_layer="split3", **KW)
    v0 = j_init_model(jcal, jax.random.PRNGKey(3), SHAPE, training=True)
    rng = np.random.default_rng(3)
    xcal = (rng.standard_normal(SHAPE)
            + np.repeat(np.arange(SPLITS), SHAPE[0] // SPLITS)[
                :, None, None, None] * 0.5).astype(np.float32)
    _, upd = jax.jit(lambda v, x: jcal.apply(
        v, x, training=True, mutable=["batch_stats"]))(v0, jnp.asarray(xcal))
    calibrated = _np_tree({"params": v0["params"],
                           "batch_stats": upd["batch_stats"]})
    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM,
                         norm_layer="split3", **KW)
    model.load_state_dict(state_dict_from_flax(calibrated), strict=True)
    return dict(calibrated=calibrated, model=model, rng=rng)


def test_bridge_maps_a_split_bn_tree_to_timms_layout(split_model):
    sd = state_dict_from_flax(split_model["calibrated"])
    model = split_model["model"]
    assert set(sd) == set(model.state_dict())
    bst = split_model["calibrated"]["batch_stats"]
    prm = split_model["calibrated"]["params"]
    np.testing.assert_array_equal(
        sd["bn1.running_var"], bst["conv_stem"]["bn1"]["main"]["bn"]["var"])
    np.testing.assert_array_equal(
        sd["bn1.aux_bn.1.weight"],
        prm["conv_stem"]["bn1"]["aux1"]["bn"]["scale"])
    np.testing.assert_array_equal(
        sd["blocks.0.0.bn1.aux_bn.0.running_mean"],
        bst["blocks_0_0"]["bn1"]["aux0"]["bn"]["mean"])
    np.testing.assert_array_equal(
        sd["bn2.aux_bn.1.bias"], prm["bn2"]["aux1"]["bn"]["bias"])
    # every BN, main and aux, has its counter; the aux weights are BN
    # scales to the PTQ naming rule, not conv kernels
    bases = {k.rsplit(".", 1)[0] for k in sd if k.endswith("running_var")}
    assert all(f"{b}.num_batches_tracked" in sd for b in bases)
    assert len(bases) == 3 * sum(isinstance(m, SplitBatchNorm2d)
                                 for m in model.modules())
    assert flax_leaf("blocks.0.0.bn1.aux_bn.0.weight") == "scale"
    assert flax_leaf("bn2.weight") == "scale"
    assert flax_leaf("blocks.0.0.conv_dw.weight") == "kernel"


def test_split_model_builds_split_bn_everywhere(split_model):
    model = split_model["model"]
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    split = [m for m in bns if isinstance(m, SplitBatchNorm2d)]
    assert split and len(bns) == 3 * len(split)
    assert all(m.num_splits == SPLITS and len(m.aux_bn) == SPLITS - 1
               for m in split)


def test_split_model_eval_logits_match_jax(split_model):
    jm = j_create_model(MODEL, bn_momentum=BN_MOMENTUM, norm_layer="split3",
                        **KW)
    x = split_model["rng"].standard_normal(SHAPE).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, training=False))(
        jax.tree.map(jnp.asarray, split_model["calibrated"]),
        jnp.asarray(x)))
    model = split_model["model"].eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).numpy()
    assert np.abs(want).max() > 1e-2      # calibrated: not collapsed
    _close_scale(got, want, "eval logits")


def _bn_stats_close(got, want, rel=1e-4):
    for k in want:
        if k.endswith("running_var"):
            base = k[:-len("running_var")]
            spread = np.sqrt(want[k].max())
            for leaf, scale in (("running_mean", spread),
                                ("running_var", spread ** 2)):
                diff = np.abs(got[base + leaf] - want[base + leaf]).max()
                assert diff <= rel * scale, (base + leaf, diff, scale)


def test_split_model_jsd_step_matches_jax(split_model):
    rng = np.random.default_rng(4)
    b = SHAPE[0] // SPLITS
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = np.tile(rng.integers(0, 2, b), SPLITS)
    calibrated = split_model["calibrated"]
    opt_cfg = types.SimpleNamespace(opt="rmsproptf", opt_eps=1e-8,
                                    momentum=0.9, weight_decay=1e-5)
    cfg = types.SimpleNamespace(jsd=True, aug_splits=SPLITS, smoothing=0.1,
                                mixup=0.0)

    jm = j_create_model(MODEL, bn_momentum=BN_MOMENTUM, norm_layer="split3",
                        **KW)
    tx = j_create_opt(opt_cfg, learning_rate=LR)
    jstep = j_make_step(jm, tx, j_losses.create_loss_fn(cfg),
                        nonfinite_guard=True, donate=False)
    js = j_state(jax.tree.map(jnp.asarray, calibrated), tx, donate=False)
    js, jmet = jstep(js, jnp.asarray(x), jnp.asarray(labels),
                     jax.random.PRNGKey(0))
    want = {k: v.numpy() for k, v in state_dict_from_flax(_np_tree(
        {"params": js.params, "batch_stats": js.batch_stats})).items()}

    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM,
                         norm_layer="split3", **KW)
    model.load_state_dict(state_dict_from_flax(calibrated), strict=True)
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    ts = create_train_state(model, create_optimizer(opt_cfg, model, LR))
    tmet = make_train_step(t_losses.create_loss_fn(cfg),
                           nonfinite_guard=True)(
        ts, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), torch.from_numpy(labels))
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    _close_rel(float(tmet["loss"]), float(jmet["loss"]), "loss", rel=1e-5)
    _close_rel(float(tmet["gnorm"]), float(jmet["gnorm"]), "gnorm",
               rel=1e-5)
    # a BN bias that feeds the next BN has a gradient of rounding noise;
    # RMSpropTF's unit initial moment makes its update lr × that noise
    floor = LR * 1e-7 * float(jmet["gnorm"])
    stats = ("running_mean", "running_var", "num_batches_tracked")
    moved = 0
    for k in want:
        if k.endswith(stats):
            continue
        _close_change(got[k], want[k], init[k], k, floor=floor)
        moved += bool(np.any(got[k] != init[k]))
    assert moved > 0
    _bn_stats_close(got, want)
    # the aux BNs normalized other rows: their stats are not the main's
    assert any(not np.allclose(got[k], got[k.replace("aux_bn.0.", "")])
               for k in got if k.endswith("aux_bn.0.running_mean"))


# the bf16 step, by tests/test_torch_amp.py's method: the port no further
# from f32 than twice the JAX package's own bf16 error (plus one bf16
# rounding of the scale), at least a quarter of it (it ran in bf16), within
# DIRECT of the JAX bf16 result, and each parameter's update within LEAF of
# its f32 update's direction and size; bounds twice the values measured
# here (beside them)
BF16_DIRECT = {"logits": 0.06,       # measured 0.0299
               "loss": 1.4e-2,       # measured 6.68e-3
               "update": 0.47,       # measured 0.236
               "bn": 2.6e-2}         # measured 1.29e-2
BF16_LEAF = (0.88, 0.55, 1.5)        # measured cos ≥ 0.942, [0.778, 1.249]
SLACK = 2.0 ** -8


def _jsd_step(calibrated, jax_dtype=None, port_dtype=None):
    """Eval logits, then one guarded JSD step from ``calibrated``: (logits,
    loss, port-named state after) of the JAX package (``jax_dtype``) or of
    the port (``port_dtype``)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = np.tile(rng.integers(0, 2, SHAPE[0] // SPLITS), SPLITS)
    opt_cfg = types.SimpleNamespace(opt="rmsproptf", opt_eps=1e-8,
                                    momentum=0.9, weight_decay=1e-5)
    cfg = types.SimpleNamespace(jsd=True, aug_splits=SPLITS, smoothing=0.1,
                                mixup=0.0)
    if port_dtype is None:
        jm = j_create_model(MODEL, bn_momentum=BN_MOMENTUM,
                            norm_layer="split3", dtype=jax_dtype, **KW)
        variables = jax.tree.map(jnp.asarray, calibrated)
        logits = jax.jit(lambda v, a: jm.apply(v, a, training=False))(
            variables, jnp.asarray(x))
        tx = j_create_opt(opt_cfg, learning_rate=LR)
        step = j_make_step(jm, tx, j_losses.create_loss_fn(cfg),
                           nonfinite_guard=True, donate=False)
        js, m = step(j_state(variables, tx, donate=False), jnp.asarray(x),
                     jnp.asarray(labels), jax.random.PRNGKey(0))
        after = state_dict_from_flax(_np_tree(
            {"params": js.params, "batch_stats": js.batch_stats}))
        return (np.asarray(logits, np.float64), float(m["loss"]),
                {k: v.numpy() for k, v in after.items()})
    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM,
                         norm_layer="split3", dtype=port_dtype, **KW)
    model.load_state_dict(state_dict_from_flax(calibrated), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        logits = model.eval()(xt).double().numpy()
    ts = create_train_state(model, create_optimizer(opt_cfg, model, LR))
    m = make_train_step(t_losses.create_loss_fn(cfg),
                        nonfinite_guard=True)(ts, xt,
                                              torch.from_numpy(labels))
    assert all(t.dtype != torch.bfloat16 for t in ts.tensors())
    return logits, float(m["loss"]), {
        k: v.detach().float().numpy().copy()
        for k, v in model.state_dict().items()}


def _bf16_hold(name, port, jax_bf16, f32):
    """The whole-quantity bounds, in 2-norm; returns the direct error."""
    p, j, f = (np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in q]) for q in (port, jax_bf16, f32))
    norm = np.linalg.norm
    e_port, e_jax, scale = norm(p - f), norm(j - f), norm(f)
    assert np.all(np.isfinite(p)), name
    assert e_port <= 2 * e_jax + SLACK * scale, (name, e_port, e_jax, scale)
    assert e_port >= e_jax / 4, (name, "not a bf16 result", e_port, e_jax)
    direct = norm(p - j) / scale
    assert direct <= BF16_DIRECT[name], (name, direct)
    return direct


@pytest.fixture(scope="module")
def bf16_runs(split_model):
    cal = split_model["calibrated"]
    return dict(f32=_jsd_step(cal), jbf=_jsd_step(cal, jax_dtype=jnp.bfloat16),
                port=_jsd_step(cal, port_dtype=torch.bfloat16),
                init={k: v.numpy()
                      for k, v in state_dict_from_flax(cal).items()})


def _bf16_checks(port, jbf, f32, init):
    """Every hold of the bf16 step; raises AssertionError on the first
    that fails."""
    _bf16_hold("logits", [port[0]], [jbf[0]], [f32[0]])
    _bf16_hold("loss", [port[1]], [jbf[1]], [f32[1]])
    stats = ("running_mean", "running_var", "num_batches_tracked")
    keys = sorted(k for k in f32[2] if not k.endswith(stats))
    up, uj, uf = ({k: sd[k].astype(np.float64) - init[k] for k in keys}
                  for sd in (port[2], jbf[2], f32[2]))
    _bf16_hold("update", [up[k] for k in keys], [uj[k] for k in keys],
               [uf[k] for k in keys])
    norm = np.linalg.norm
    cos_min, lo, hi = BF16_LEAF
    largest = max(norm(u) for u in uf.values())
    for k in keys:
        if norm(uf[k]) <= 1e-6 * largest:     # a gradient that cancels
            assert norm(up[k]) <= SLACK * largest, k
            continue
        a, b = up[k].ravel(), uf[k].ravel()
        cos = a @ b / (norm(a) * norm(b)) if norm(a) else 0.0
        assert cos >= cos_min and lo <= norm(a) / norm(b) <= hi, \
            (k, cos, norm(a) / norm(b))
    # every BN's statistics, main and aux: a mean against the channel
    # spread, a var against var
    for k in f32[2]:
        if k.endswith(("running_mean", "running_var")):
            var = f32[2][k.rsplit(".", 1)[0] + ".running_var"].max()
            scale = var if k.endswith("var") else np.sqrt(var)
            e_port = np.abs(port[2][k] - f32[2][k]).max()
            e_jax = np.abs(jbf[2][k] - f32[2][k]).max()
            assert e_port <= 2 * e_jax + SLACK * scale, (k, e_port, e_jax)
            assert np.abs(port[2][k] - jbf[2][k]).max() <= \
                BF16_DIRECT["bn"] * scale, k


def test_split_model_jsd_step_in_bf16_matches_jax(bf16_runs):
    r = bf16_runs
    _bf16_checks(r["port"], r["jbf"], r["f32"], r["init"])


@pytest.mark.parametrize("fault", ["unchanged", "f32_step"])
def test_bf16_holds_reject_a_planted_fault(bf16_runs, fault):
    """An unchanged state, or the f32 step in the bf16 step's place, must
    fail the holds."""
    r = bf16_runs
    if fault == "unchanged":
        port = (r["port"][0], r["port"][1], dict(r["init"]))
    else:
        port = r["f32"]
    with pytest.raises(AssertionError):
        _bf16_checks(port, r["jbf"], r["f32"], r["init"])


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

SMALL = ["--dataset", "synthetic", "--model", "efficientnet_b0",
         "--model-version", "", "--input-size-v2", "12,32,32", "-b", "2",
         "--compute-dtype", "float32", "--device", "cpu"]


def test_flag_errors_match_the_jax_runner(tmp_path):
    """Each bad combination fails on both sides with the JAX message."""
    out = ["--output", str(tmp_path)]
    bad_split = runner.parse_args(SMALL + out + ["--split-bn"])
    with pytest.raises(ValueError, match=r"--split-bn needs --aug-splits "
                                         r"> 1 or --resplit") as te:
        runner.build_model(bad_split, "cpu")
    jcfg = j_config.TrainConfig.from_args(
        ["--dataset", "synthetic", "--model", "efficientnet_b0",
         "--model-version", "", "--split-bn"])
    with pytest.raises(ValueError) as je:
        j_runner.build_model(jcfg, 12)
    assert str(te.value) == str(je.value)
    # --resplit is enough: split2
    ok = runner.parse_args(SMALL + out + ["--split-bn", "--resplit"])
    assert runner.build_model(ok, "cpu").bn1.num_splits == 2

    with pytest.raises(ValueError, match="--jsd requires --aug-splits > 1"):
        t_losses.create_loss_fn(runner.parse_args(SMALL + ["--jsd"]))
    with pytest.raises(AssertionError,
                       match="--jsd requires --aug-splits > 1"):
        j_losses.create_loss_fn(types.SimpleNamespace(jsd=True,
                                                      aug_splits=0))

    # aug splits exclude the mixup collate, in both loaders
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_loader.create_loader(t_dataset.SyntheticDataset(8, (8, 8, 12)), 2,
                               True, "cpu", img_num=4, num_aug_splits=3,
                               collate_mixup=t_mixup.FastCollateMixup(
                                   0.1, 0.1, 2))
    with pytest.raises(AssertionError, match="mutually exclusive"):
        j_loader.create_loader(j_dataset.SyntheticDataset(8, (8, 8, 12)),
                               (12, 8, 8), 2, is_training=True,
                               num_aug_splits=3,
                               collate_mixup=j_mixup.FastCollateMixup(
                                   0.1, 0.1, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        runner.setup(runner.parse_args(SMALL + out + [
            "--aug-splits", "3", "--mixup", "0.1"]))


def test_runner_trains_augmix_with_split_bn_and_resumes(tmp_path):
    argv = SMALL + ["--epochs", "1", "--aug-splits", "3", "--jsd",
                    "--split-bn", "--reprob", "0.3", "--resplit",
                    "--model-ema", "--workers", "2",
                    "--output", str(tmp_path), "--experiment", "augmix"]
    cfg = runner.parse_args(argv)
    init = runner.build_model(cfg, "cpu").state_dict()
    result = runner.main(cfg)
    assert np.isfinite(result["train"]["loss"])
    assert np.isfinite(result["eval"]["loss"])
    ck = torch.load(tmp_path / "augmix" / "last.pth.tar",
                    map_location="cpu", weights_only=True)
    for part in ("state_dict", "state_dict_ema"):
        sd = ck[part]
        assert set(sd) == set(init), part
    sd = ck["state_dict"]
    aux = [k for k in sd if ".aux_bn." in k and k.endswith("running_mean")]
    assert aux and all(not torch.equal(sd[k], init[k]) for k in aux)
    # every aux BN saw other rows than its main BN
    assert all(not torch.equal(sd[k], sd[k.replace("aux_bn.0.", "")])
               for k in aux if ".aux_bn.0." in k)
    assert int(sd["bn1.aux_bn.1.num_batches_tracked"]) == \
        int(sd["bn1.num_batches_tracked"]) == result["loader"]["batches"]
    # a run resumed from the checkpoint loads it strictly, aux BNs included
    again = runner.parse_args(argv[:-2] + ["--experiment", "again",
                                           "--resume",
                                           str(tmp_path / "augmix"
                                               / "last.pth.tar"),
                                           "--epochs", "2"])
    result2 = runner.main(again)
    assert np.isfinite(result2["train"]["loss"])
