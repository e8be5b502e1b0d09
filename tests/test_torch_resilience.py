"""PyTorch port, the recovery layer on CPU (against the JAX package where
it has a counterpart).

* ``chaos.ChaosInjector``: the same specs parse to the same points and fire
  at the same (name, step) pairs, once each, as the JAX ``chaos.py``; the
  two registries of point names are equal;
* ``AnomalyGuard``: the same verdicts (bad steps, spikes, the rewind raise)
  as the JAX class on seeded loss sequences with NaNs and spikes;
* ``StallWatchdog``: fires with exit code 85 after its timeout, waits
  ``first_grace`` times longer before the first beat, stays quiet while
  beaten; ``PreemptionHandler`` installs and restores the handlers;
* ``allreduce_flags`` and ``Resilience.sync_verdicts`` are the identity on
  one process: the stop verdict is this process's signal flag;
* checkpoints: ``CheckpointCorrupt`` for a truncated, an empty and a
  garbage file; ``find_resume_candidates`` in the JAX order on the same
  listing; an async snapshot owns its bytes (the live state changes after
  the call, the file does not); ``save_recovery(sync=True)`` is on disk
  when it returns; a resumed ``TrainState`` equals the saved one;
* the loader's ``fast_forward``: the tail of an epoch after it is bitwise
  the tail of the whole epoch (images, labels, soft targets), with the
  thread workers, erasing, jitter, flicker, the warp and mixup on, from a
  clip tree and from its pack; on ``--loader-backend shm`` the tail is
  bitwise the thread transport's, and a ``kill_shm_worker`` run recovers
  to the thread transport's batches.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deepfake_detection_tpu import chaos as j_chaos
from deepfake_detection_tpu.train import checkpoint as j_ckpt
from deepfake_detection_tpu.train import resilience as j_res
from deepfake_detection_tpu_torch import chaos
from deepfake_detection_tpu_torch.data.packed import write_pack
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train import checkpoint as ckpt
from deepfake_detection_tpu_torch.train import resilience as res
from deepfake_detection_tpu_torch.train.state import create_train_state
from test_torch_data import make_clip_tree

torch.set_num_threads(2)

SPECS = ["", "sigterm@11", "nanbatch@4x3", "stall_loader@3:30.5",
         "nanbatch@2x2,sigterm@7,truncate_ckpt@5",
         "kill_shm_worker@1x4:-2e-1"]


def test_known_points_are_the_jax_registry():
    assert chaos.KNOWN_POINTS == j_chaos.KNOWN_POINTS
    assert chaos.CHAOS_ENV_VAR == j_chaos.CHAOS_ENV_VAR


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_parses_and_fires_as_jax(spec):
    a, b = chaos.ChaosInjector(spec), j_chaos.ChaosInjector(spec)
    assert a.points == b.points and a.active == b.active
    for name in sorted(chaos.KNOWN_POINTS):
        assert a.arg(name, 1.5) == b.arg(name, 1.5)
        for step in list(range(14)) + [3, 4, 5]:     # repeats fire once
            assert a.fires(name, step) == b.fires(name, step), (name, step)


@pytest.mark.parametrize("bad", ["nanbatch", "nanbatch@x", "Sigterm@1",
                                 "sigterm@1:abc"])
def test_chaos_rejects_bad_specs(bad):
    with pytest.raises(ValueError, match="bad DFD_CHAOS entry"):
        chaos.ChaosInjector(bad)


def _losses(seed):
    rng = np.random.default_rng(seed)
    x = 1.0 + 0.05 * rng.standard_normal(60)
    x[[12, 31]] = 9.0                               # spikes
    x[[20, 40, 41, 42]] = np.nan                    # a burst of three
    return x


@pytest.mark.parametrize("kw", [dict(), dict(spike_window=8),
                                dict(spike_window=8, spike_zmax=3.0,
                                     rewind_after=2)])
def test_anomaly_guard_verdicts_match_jax(kw):
    for seed in range(3):
        ga, gb = res.AnomalyGuard(**kw), j_res.AnomalyGuard(**kw)
        for i, loss in enumerate(_losses(seed)):
            outs = []
            for g, exc in ((ga, res.RewindRequested),
                           (gb, j_res.RewindRequested)):
                try:
                    outs.append(g.observe(i, float(loss), False))
                except exc:
                    outs.append("rewind")
                    g.reset_streak()
            assert outs[0] == outs[1], (kw, seed, i)
        assert (ga.nonfinite_total, ga.spike_total) == \
            (gb.nonfinite_total, gb.spike_total)


def test_stall_watchdog_fires_after_its_grace_and_its_timeout():
    fired = []
    wd = res.StallWatchdog(0.2, position_fn=lambda: "here",
                           exit_fn=fired.append, first_grace=3.0)
    wd.start()
    time.sleep(0.4)                     # within the first-beat grace (0.6)
    assert not fired
    for _ in range(4):                  # beaten: quiet
        wd.beat()
        time.sleep(0.1)
    assert not fired and wd.beats_total == 4
    time.sleep(0.6)
    wd.stop()
    assert fired == [res.EXIT_WATCHDOG] == [85]


def test_preemption_handler_installs_and_restores():
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    h = res.PreemptionHandler()
    assert h.install()
    assert signal.getsignal(signal.SIGTERM) == h._handle
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)
    assert h.stop_requested and h.signum == signal.SIGTERM
    h.uninstall()
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before
    # off the main thread it declines, leaving nothing installed
    out = []
    t = threading.Thread(target=lambda: out.append(
        res.PreemptionHandler().install()))
    t.start()
    t.join()
    assert out == [False]
    assert res.EXIT_PREEMPTED == 75


def test_allreduce_flags_and_sync_verdicts_on_one_process():
    """One process: the flags come back as they are, and the agreed stop
    is this process's own flag, before and after a SIGTERM."""
    out = res.allreduce_flags(np.array([0, 1, 1]))
    assert out.dtype == np.int32 and list(out) == [0, 1, 1]
    r = res.Resilience(preemption=res.PreemptionHandler())
    assert r.sync_verdicts() is False
    with r:
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert r.sync_verdicts() is True
        assert r.stop_signum == signal.SIGTERM
    assert res.Resilience().sync_verdicts() is False      # no handler


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0, ema=True):
    model = create_model("efficientnet_b0", num_classes=2, device="cpu",
                         seed=seed)
    return create_train_state(model, create_optimizer(
        runner.TrainConfig(), model, 1e-3), with_ema=ema,
        generator=torch.Generator().manual_seed(seed))


def _tensors(payload):
    out = dict(payload["state_dict"])
    out.update({f"ema.{k}": v for k, v in payload["state_dict_ema"].items()})
    for i, st in payload["optimizer"]["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    out["generator"] = payload["generator"]
    return out


@pytest.mark.parametrize("damage", ["truncated", "empty", "garbage",
                                    "no_state_dict"])
def test_corrupt_files_raise_checkpoint_corrupt(tmp_path, damage):
    path = str(tmp_path / "recovery-0-3.pth.tar")
    ckpt.save_checkpoint_file(path, ckpt.checkpoint_payload(
        _state(ema=False), 0, {"model": "b0"}))
    if damage == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif damage == "empty":
        open(path, "wb").close()
    elif damage == "garbage":
        with open(path, "wb") as f:
            f.write(os.urandom(4096))
    else:
        torch.save({"epoch": 0}, path)
    with pytest.raises(ckpt.CheckpointCorrupt, match="corrupt or truncated"):
        ckpt.load_checkpoint_file(path)


def test_find_resume_candidates_in_the_jax_order(tmp_path):
    names = ["recovery-0-999", "recovery-0-1099", "recovery-2-3",
             "recovery-10-0", "recovery-2-10"]
    out = {}
    for pkg, ext in (("jax", ".ckpt"), ("port", ".pth.tar")):
        d = tmp_path / pkg
        (d / "_bak").mkdir(parents=True)
        for n in names + ["model_best", "_bak/model_best", "checkpoint-3",
                          "last"]:
            (d / (n + ext)).write_bytes(b"x")
        fn = j_ckpt.find_resume_candidates if pkg == "jax" \
            else ckpt.find_resume_candidates
        out[pkg] = [os.path.relpath(p, d)[:-len(ext)]
                    for p in fn(str(d), bak_dir=str(d / "_bak"))]
    assert out["port"] == out["jax"] == [
        "recovery-10-0", "recovery-2-10", "recovery-2-3", "recovery-0-1099",
        "recovery-0-999", "_bak/model_best", "model_best"]


def test_async_snapshot_owns_its_bytes(tmp_path):
    """The live state changes right after the call (before the background
    write can have run): the file holds the state of the call."""
    state = _state()
    saver = ckpt.CheckpointSaver(str(tmp_path))
    want = {k: v.clone() for k, v in _tensors(ckpt.checkpoint_payload(
        state, 0, {})).items()}
    gate = threading.Event()
    ckpt._write_pool.submit(gate.wait)     # hold the writer thread
    path = saver.save_recovery(state, {}, 0, 4, 5)
    with torch.no_grad():
        for t in state.tensors():
            t.add_(1) if t.is_floating_point() else t.add_(3)
        torch.rand(8, generator=state.generator)   # advance it
    gate.set()
    ckpt.wait_pending_saves()
    got = _tensors(ckpt.load_checkpoint_file(path))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    meta = ckpt.load_checkpoint_file(path)
    assert (meta["epoch"], meta["batch_idx"], meta["num_updates"]) == \
        (0, 4, 5)


def test_sync_recovery_lands_at_once_and_rotates(tmp_path):
    saver = ckpt.CheckpointSaver(str(tmp_path))
    state = _state(ema=False)
    gate = threading.Event()
    ckpt._write_pool.submit(gate.wait)     # a writer that never gets to run
    try:
        path = saver.save_recovery(state, {}, 1, 2, 9, sync=True)
        assert os.path.isfile(path)
        assert torch.load(path, weights_only=True)["batch_idx"] == 2
    finally:
        gate.set()
    for b in (3, 4):
        saver.save_recovery(state, {}, 1, b, 9 + b)
    ckpt.wait_pending_saves()
    assert sorted(os.listdir(tmp_path)) == ["recovery-1-3.pth.tar",
                                           "recovery-1-4.pth.tar"]
    assert saver.find_recovery().endswith("recovery-1-4.pth.tar")


def test_restore_train_state_round_trip(tmp_path):
    """A restored state is the saved one: model, BN stats, EMA, optimizer
    (its lr too), step and generator; with ``load_opt=False`` the fresh
    optimizer, step and generator stay."""
    src = _state(seed=1)
    for g in src.optimizer.param_groups:
        g["lr"] = 0.123
    with torch.no_grad():
        for t in src.tensors():
            if t.is_floating_point():
                t.add_(torch.randn(t.shape, generator=src.generator))
        src.step.fill_(7)
    torch.rand(5, generator=src.generator)
    path = str(tmp_path / "recovery-0-6.pth.tar")
    ckpt.save_checkpoint_file(path, ckpt.checkpoint_payload(
        src, 0, {"model": "b0"}, meta={"batch_idx": 6, "num_updates": 7}))
    dst = _state(seed=2)
    meta = ckpt.restore_train_state(path, dst)
    assert (meta["epoch"], meta["batch_idx"], meta["step"]) == (0, 6, 7)
    for a, b in zip(dst.tensors(), src.tensors()):
        assert torch.equal(a, b)
    assert dst.optimizer.param_groups[0]["lr"] == 0.123
    assert torch.equal(dst.generator.get_state(), src.generator.get_state())
    fresh = _state(seed=2)
    ckpt.restore_train_state(path, fresh, load_opt=False)
    assert int(fresh.step) == 0
    assert fresh.optimizer.param_groups[0]["lr"] != 0.123
    assert torch.equal(fresh.model.state_dict()["conv_stem.weight"],
                       src.model.state_dict()["conv_stem.weight"])


# ---------------------------------------------------------------------------
# fast_forward
# ---------------------------------------------------------------------------

FF_ARGS = ["--model", "efficientnet_b0", "--model-version", "",
           "--input-size-v2", "12,32,32", "-b", "2", "--label-balance",
           "--rotate-range", "5", "--blur-prob", "0.5", "--mixup", "0.2",
           "--reprob", "0.5", "--remode", "pixel", "--flicker", "0.1",
           "--color-jitter", "0.4", "--workers", "3", "--seed", "9",
           "--device", "cpu"]


@pytest.fixture(scope="module")
def ff_tree(tmp_path_factory):
    root = make_clip_tree(str(tmp_path_factory.mktemp("ff")), n_real=5,
                          n_fake=9, hw=(40, 40))
    pack = str(tmp_path_factory.mktemp("ffpack"))
    write_pack(root, pack, workers=2)
    return root, pack


@pytest.mark.parametrize("source", ["tree", "pack"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fast_forward_tail_is_bitwise_the_whole_epochs(ff_tree, source,
                                                       dtype):
    root, pack = ff_tree
    argv = FF_ARGS + ["--data", root, "--compute-dtype", dtype]
    if source == "pack":
        argv += ["--data-packed", pack]
    cfg = runner.parse_args(argv)
    loader, _ = runner.build_loaders(cfg, torch.device("cpu"),
                                     *runner.build_datasets(cfg))
    epoch = 1
    loader.set_epoch(epoch)
    whole = list(loader)
    assert len(whole) == len(loader) >= 4
    start = len(whole) - 2
    loader.set_epoch(epoch)
    loader.fast_forward(start)
    tail = list(loader)
    assert len(tail) == len(whole) - start
    for (xa, ya), (xb, yb) in zip(tail, whole[start:]):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert whole[0][1].dtype == torch.float32          # soft targets
    # the next set_epoch clears it: a whole epoch again
    loader.set_epoch(epoch)
    assert len(list(loader)) == len(whole)


def _epoch_list(loader, epoch, start=0, deadline=60.0):
    """``list(loader)`` of ``epoch`` from batch ``start``, on a thread
    joined within ``deadline`` seconds (the shm transport spawns
    workers)."""
    out = []

    def run():
        loader.set_epoch(epoch)
        loader.fast_forward(start)
        out.extend(loader)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(deadline)
    assert not t.is_alive(), f"no epoch within {deadline:.0f} s"
    return out


def _runner_loader(root, backend, *extra):
    cfg = runner.parse_args(FF_ARGS + ["--data", root, "--compute-dtype",
                                       "float32", "--loader-backend",
                                       backend, *extra])
    return runner.build_loaders(cfg, torch.device("cpu"),
                                *runner.build_datasets(cfg))[0]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (xa, ya), (xb, yb) in zip(got, want):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)


def test_shm_tail_is_bitwise_the_thread_tail(ff_tree):
    """``--loader-backend shm`` resumed mid-epoch: the tail is bitwise the
    thread transport's whole epoch from that batch."""
    root, _ = ff_tree
    whole = _epoch_list(_runner_loader(root, "thread"), 1)
    shm = _runner_loader(root, "shm")
    try:
        start = len(whole) - 2
        _same_batches(_epoch_list(shm, 1, start), whole[start:])
    finally:
        shm.close()


def test_kill_shm_worker_recovers_to_the_same_batches(ff_tree, monkeypatch):
    """``DFD_CHAOS=kill_shm_worker@2``: the one worker dies after its
    second task, mid-epoch, holding the task it had just taken but not yet
    published; the collector respawns it (without the spec), the lost-ack
    sweep re-dispatches that task (after 5 s: ``--worker-heartbeat 8``),
    and the epoch is bitwise the thread transport's (3 threads: a batch is
    the same for any worker count)."""
    root, _ = ff_tree
    want = _epoch_list(_runner_loader(root, "thread"), 0)
    monkeypatch.setenv(chaos.CHAOS_ENV_VAR, "kill_shm_worker@2")
    hurt = _runner_loader(root, "shm", "--workers", "1",
                          "--worker-heartbeat", "8")
    try:
        _same_batches(_epoch_list(hurt, 0), want)
        assert hurt.loader.respawn_count >= 1
        assert hurt.loader.stall_sweeps >= 1
        assert os.environ[chaos.CHAOS_ENV_VAR] == "kill_shm_worker@2"
    finally:
        hurt.close()
