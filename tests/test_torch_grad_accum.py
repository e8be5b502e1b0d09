"""PyTorch port, gradient accumulation (``--grad-accum N``) on the CPU.

* The port's ``make_train_step(grad_accum=N)`` at N = 2 and 3 against the
  JAX ``make_train_step(grad_accum=N)`` (its XLA depthwise,
  ``fused_depthwise="off"``) on the reduced flagship of
  ``test_torch_train.py`` (a quarter width, 10 blocks) at 12×64², batch 6,
  f32, from BN calibrated by one JAX train-mode pass and carried across by
  ``convert.state_dict_from_flax``: rmsproptf, soft-target CE on fixed
  mixup targets, a clip that clips, the EMA and the guard, two steps.
  Tolerances as ``test_torch_train.py``'s: loss and the gradient norm
  1e-5 relative; every parameter, moment and EMA leaf within 1e-4 of its
  change (plus 2 f32 ulps a step and the noise floor of the leaves whose
  gradient is rounding noise); BN running stats, carried from microbatch
  to microbatch, 1e-4 of their spread.
* The strided split: row j of microbatch i is row j·N + i, and a
  split-major AugMix batch (``--aug-splits 3``, each split N·b rows)
  stays split-major in every microbatch, so the JSD loss and the split BN
  see their clean and augmented splits in each.
* The guard with N > 1: a NaN in the last microbatch leaves the whole
  state (BN stats the earlier microbatches moved included) bitwise as it
  was, and the guard's copy is taken once a step.
* The runner with ``--grad-accum 2``: the loader's batch is ``-b × 2``,
  the eval batch is not multiplied, the lr is scaled by 2, and a SIGTERM
  mid-epoch → exit 75 → ``--auto-resume`` lands bitwise on the
  uninterrupted run's state.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import (_microbatches,
                                                      make_train_step)
from test_torch_chaos_e2e import _RUNNER, _state
from test_torch_train import (KW, MODEL, _bn_stats_close,
                              _close_change, _close_rel, _jax_snapshot,
                              _np_tree, _opt_cfg, _port_snapshot)

torch.set_num_threads(2)

SHAPE = (6, 64, 64, 12)
LR, CLIP, EMA_DECAY, BN_MOMENTUM, STEPS = 0.02, 0.5, 0.9, 0.1, 2
GRAD_FLOOR = 1e-7 * CLIP
STATE_FLOOR = LR * GRAD_FLOOR * STEPS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _calibrated(rng):
    jcal = j_create_model(MODEL, bn_momentum=1.0, **KW)
    v0 = j_init_model(jcal, jax.random.PRNGKey(3), SHAPE)
    xcal = rng.standard_normal(SHAPE).astype(np.float32)
    _, upd = jax.jit(lambda v, x: jcal.apply(
        v, x, training=True, mutable=["batch_stats"]))(v0, jnp.asarray(xcal))
    return _np_tree({"params": v0["params"],
                     "batch_stats": upd["batch_stats"]})


@pytest.fixture(scope="module", params=[2, 3], ids=["accum2", "accum3"])
def accum_run(request):
    """Two accumulated steps in both packages from the same weights."""
    n = request.param
    rng = np.random.default_rng(10 + n)
    calibrated = _calibrated(rng)
    batches = []
    for i in range(STEPS):
        x = rng.standard_normal(SHAPE).astype(np.float32)
        labels = rng.integers(0, 2, SHAPE[0])
        y = j_mixup.mixup_target_np(labels, 2, 0.6 + 0.1 * i, 0.1).astype(
            np.float32)
        batches.append((x, y))

    jm = j_create_model(MODEL, bn_momentum=BN_MOMENTUM, **KW)
    tx = j_create_opt(_opt_cfg("rmsproptf"), learning_rate=LR)
    jstep = j_make_step(jm, tx, j_losses.soft_target_cross_entropy,
                        ema_decay=EMA_DECAY, clip_grad=CLIP, grad_accum=n,
                        nonfinite_guard=True, donate=False)
    key = jax.random.PRNGKey(0)
    js = j_state(jax.tree.map(jnp.asarray, calibrated), tx, with_ema=True,
                 donate=False)
    j_snaps, j_metrics = [_jax_snapshot(js)], []
    for x, y in batches:
        js, m = jstep(js, jnp.asarray(x), jnp.asarray(y), key)
        j_snaps.append(_jax_snapshot(js))
        j_metrics.append({k: float(v) for k, v in m.items()})

    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM, **KW)
    model.load_state_dict(state_dict_from_flax(calibrated), strict=True)
    ts = create_train_state(model, create_optimizer(_opt_cfg("rmsproptf"),
                                                    model, LR),
                            with_ema=True, ema_decay=EMA_DECAY)
    tstep = make_train_step(t_losses.soft_target_cross_entropy,
                            clip_grad=CLIP, nonfinite_guard=True,
                            grad_accum=n)
    t_snaps, t_metrics = [_port_snapshot(ts)], []
    for x, y in batches:
        m = tstep(ts, torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(y))
        t_snaps.append(_port_snapshot(ts))
        t_metrics.append({k: float(v) for k, v in m.items()})
    return dict(j=j_snaps, t=t_snaps, jm=j_metrics, tm=t_metrics, n=n)


def test_accumulated_loss_and_gradient_norm_match_jax(accum_run):
    for i, (tm, jm) in enumerate(zip(accum_run["tm"], accum_run["jm"])):
        _close_rel(tm["loss"], jm["loss"], f"loss step {i}", rel=1e-5)
        _close_rel(tm["gnorm"], jm["gnorm"], f"gnorm step {i}", rel=1e-5)
        assert tm["prec1"] == pytest.approx(jm["prec1"], abs=1e-4)
        assert tm["nonfinite"] == jm["nonfinite"] == 0.0
    assert accum_run["tm"][0]["gnorm"] == pytest.approx(CLIP, rel=1e-5), \
        "the test's clip threshold must clip"


@pytest.mark.parametrize("after", [1, STEPS])
def test_accumulated_state_matches_jax(accum_run, after):
    """Params (as updates), BN running stats carried over the
    microbatches, RMSprop moments and the EMA after ``after`` steps; one
    optimizer step a batch (the step counter)."""
    t, j = accum_run["t"][after], accum_run["j"][after]
    t0, j0 = accum_run["t"][0], accum_run["j"][0]
    assert t["step"] == j["step"] == after
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k in j["model"]:
        if not k.endswith(stats):
            _close_change(t["model"][k], j["model"][k], j0["model"][k], k,
                          floor=STATE_FLOOR, steps=after)
    _bn_stats_close(t["model"], j["model"])
    _bn_stats_close(t["ema"], j["ema"])
    for part in ("square_avg", "momentum"):
        for k in j[part]:
            _close_change(t[part][k], j[part][k], j0[part][k], f"{part} {k}",
                          floor=STATE_FLOOR, steps=after)
    for k in j["ema"]:
        if not k.endswith(stats):
            _close_change(t["ema"][k], j["ema"][k], j0["ema"][k], f"ema {k}",
                          floor=STATE_FLOOR, steps=after)
    # each microbatch's forward is one BN update: N a step
    n_bt = [int(v) for k, v in t["model"].items()
            if k.endswith("num_batches_tracked")]
    assert n_bt and set(n_bt) == {after * accum_run["n"]}


@pytest.mark.parametrize("n", [2, 3])
def test_strided_split_keeps_augmix_batches_split_major(n):
    """Row j of microbatch i is row j·n + i; under ``--aug-splits 3`` a
    loader batch of 3 splits × (n·b) rows splits into microbatches of 3
    splits × b rows, split-major, each row beside its own views."""
    b, splits = 2, 3
    rows = splits * n * b
    # row r = split s, sample k: value 100·s + k
    ids = torch.tensor([100 * (r // (n * b)) + r % (n * b)
                        for r in range(rows)], dtype=torch.float32)
    x = ids[:, None, None, None].expand(rows, 2, 3, 3).contiguous(
        memory_format=torch.channels_last)
    parts = _microbatches(x, n)
    labels = _microbatches(ids, n)
    for i, (xi, yi) in enumerate(zip(parts, labels)):
        assert xi.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(xi[:, 0, 0, 0], ids[i::n])
        got = yi.reshape(splits, b)
        for s in range(splits):
            # split s of the microbatch: samples i, i+n, ... of split s
            assert got[s].tolist() == [100 * s + i + j * n for j in range(b)]
    with pytest.raises(ValueError, match="microbatches"):
        _microbatches(torch.zeros(5, 1), 2)


def test_guard_rolls_back_an_accumulated_step_bitwise():
    """A NaN in the last of three microbatches: the loss is not finite,
    so the whole state, the BN stats the first two forwards moved
    included, comes back bitwise; the next clean step trains."""
    torch.manual_seed(0)
    model = create_model(MODEL, device="cpu", bn_momentum=BN_MOMENTUM,
                         **KW)
    ts = create_train_state(model, create_optimizer(_opt_cfg("rmsproptf"),
                                                    model, LR),
                            with_ema=True, ema_decay=EMA_DECAY)
    step = make_train_step(t_losses.cross_entropy, clip_grad=CLIP,
                           nonfinite_guard=True, grad_accum=3)
    copies = []
    real_clone = torch.Tensor.clone

    def counting_clone(t, *a, **k):
        copies.append(t.numel())
        return real_clone(t, *a, **k)

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 12, 32, 32)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    y = torch.tensor([0, 1, 0, 1, 1, 0])
    ts.flat_buffers()
    before = [t.clone() for t in ts.tensors()]
    bad = x.clone()
    bad[2::3] = float("nan")                  # microbatch 2 (the last)
    torch.Tensor.clone = counting_clone
    try:
        m = step(ts, bad, y)
    finally:
        torch.Tensor.clone = real_clone
    assert float(m["nonfinite"]) == 1.0
    # one copy a dtype of the flat state, not one a microbatch
    flat_sizes = sorted(f.numel() for f in ts.flat_buffers().values())
    assert sorted(n for n in copies if n in flat_sizes) == flat_sizes
    after = ts.tensors()
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    m = step(ts, x, y)
    assert float(m["nonfinite"]) == 0.0 and int(ts.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(ts.tensors(), before))


ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model",
        "efficientnet_b0", "--model-version", "", "--input-size-v2",
        "3,32,32", "-b", "2", "--grad-accum", "2", "--epochs", "1",
        "--opt", "rmsproptf", "--basic-lr", "1e-3", "--log-interval", "1",
        "--seed", "3", "--compute-dtype", "float32", "--workers", "1"]


def test_runner_scales_the_loader_batch_and_the_lr():
    cfg = runner.parse_args(ARGS)
    assert cfg.grad_accum == 2
    run = runner.setup(cfg)
    try:
        assert run.train_loader.loader.batch_size == 4
        assert run.eval_loader.loader.batch_size == 4     # 2 × -b, not × N
        lr = run.state.optimizer.param_groups[0]["lr"]
        assert lr == pytest.approx(2 * 2 * 1e-3)          # b × N × basic
        x, y = next(iter(run.train_loader))
        assert x.shape[0] == y.shape[0] == 4
        m = run.train_step(run.state, x, y)
        assert np.isfinite(float(m["loss"])) and int(run.state.step) == 1
    finally:
        run.train_loader.close()
        run.eval_loader.close()
    with pytest.raises(ValueError, match="grad-accum"):
        runner.parse_args(ARGS + ["--grad-accum", "0"])


# 16 synthetic samples at a loader batch of 2 × 2 → 4 optimizer steps
_RESUME = ["--dataset", "synthetic", "--model", "efficientnet_deepfake_v4",
           "--model-version", "v4", "--input-size-v2", "12,32,32", "-b", "2",
           "--grad-accum", "2", "--opt", "rmsproptf", "--lr", "1e-3",
           "--epochs", "1", "--bn-momentum", "0.1", "--mixup", "0.1",
           "--model-ema", "--workers", "1", "--log-interval", "1",
           "--device", "cpu", "--seed", "5", "--compute-dtype", "float32",
           "--auto-resume", "--recovery-interval", "1", "--experiment",
           "run"]


def _launch(out, chaos=""):
    """The runner with the flagship cut to a quarter width and 10 blocks
    in a fresh interpreter, as ``tests/test_torch_chaos_e2e.py`` runs it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DFD_CHAOS", None)
    if chaos:
        env["DFD_CHAOS"] = chaos
    return subprocess.Popen([sys.executable, "-c", _RUNNER, *_RESUME,
                             "--output", str(out)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc, rc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == rc, f"rc={proc.returncode}\n{err[-3000:]}"
    return out + err


def test_mid_epoch_resume_with_grad_accum_is_bitwise(tmp_path):
    """SIGTERM after optimizer update 2 of 4 → exit 75 with a snapshot →
    ``--auto-resume`` continues at batch 2 and ends bitwise on the
    uninterrupted run (params, BN stats, moments, EMA, step)."""
    ref = _launch(tmp_path / "ref")
    cut = _launch(tmp_path / "cut", chaos="sigterm@2")
    _wait(ref, 0)
    _wait(cut, 75)
    run = tmp_path / "cut" / "run"
    assert (run / "recovery-0-1.pth.tar").exists(), os.listdir(run)
    assert not (run / "checkpoint-0.pth.tar").exists()
    log = _wait(_launch(tmp_path / "cut"), 0)
    assert "Auto-resumed from" in log and "recovery-0-1" in log
    want = _state(tmp_path / "ref" / "run" / "checkpoint-0.pth.tar")
    got = _state(run / "checkpoint-0.pth.tar")
    assert got.keys() == want.keys()
    assert int(want["step"]) == 4
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, (bad[:5], len(bad))
