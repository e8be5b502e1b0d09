"""PyTorch port, end-to-end injected-fault recovery on the CPU.

Each recovery path of the port's ``train/resilience.py`` is driven by a
real fault (``DFD_CHAOS``) injected into a real ``runners.train`` run in a
fresh interpreter, against the exit-code contract, as the JAX package's
``tests/test_chaos_e2e.py`` does:

* SIGTERM mid-epoch → exit 75 with a synchronous recovery snapshot →
  ``--auto-resume`` → the final params, BN stats, optimizer state and EMA
  bitwise those of an uninterrupted run; the same on ``--loader-backend
  shm`` (both runs), bitwise the uninterrupted run on the thread transport;
* a NaN-batch burst → guarded skips, then a rewind to the last snapshot
  that replays the span clean → completes bitwise as uninterrupted;
* a wedged loader → the stall watchdog's exit 85 with a stack dump;
* a newest snapshot torn by the ``truncate_ckpt`` probe (after the
  background write it tears has landed) → ``--auto-resume`` falls back to
  the one before and still lands bitwise on the uninterrupted state.

The runs train the reduced flagship (``efficientnet_deepfake_v4`` at a
quarter width and 10 blocks, as ``test_torch_train.py``) at 12×32², batch
2, from a clip tree of ``.npy`` frames, with ``scripts/train.sh``'s
augment flags, ``--reprob 0.25`` and ``--mixup 0.1`` (so bit-identity also
proves that the loader's samples and mixup and the prologue's warp, blur,
jitter and erasing draws fast-forward) and the EMA, in bf16 (``--amp``,
the JAX runner's compute policy); the preemption case runs in f32 too.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from deepfake_detection_tpu_torch.train.checkpoint import (
    CheckpointCorrupt, load_checkpoint_file)
from test_torch_data import make_clip_tree

pytestmark = pytest.mark.chaos

EXIT_PREEMPTED, EXIT_WATCHDOG = 75, 85
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the runner with the flagship cut to a quarter width and 10 blocks
_RUNNER = """
import functools, sys
import torch
torch.set_num_threads(1)
from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
from deepfake_detection_tpu_torch.runners import train
train._MODEL_FACTORIES["v4"] = functools.partial(
    create_deepfake_model_v4, channel_multiplier=0.25, depth_multiplier=0.34)
train.launch_main(sys.argv[1:])
"""

# 12 train samples (label balance) → 6 steps of batch 2 an epoch
_BASE = ["--model", "efficientnet_deepfake_v4", "--model-version", "v4",
         "--input-size-v2", "12,32,32", "-b", "2", "--opt", "rmsproptf",
         "--lr", "1e-3", "--sched", "step", "--epochs", "1",
         "--reprob", "0.25", "--remax", "0.05", "--flicker", "0.05",
         "--rotate-range", "5", "--blur-prob", "0.3", "--bn-momentum", "0.1",
         "--mixup", "0.1", "--label-balance", "--model-ema",
         "--eval-metric", "loss", "--workers", "1", "--log-interval", "2",
         "--device", "cpu", "--seed", "7", "--auto-resume",
         "--recovery-interval", "2", "--experiment", "run"]
AMP = ["--amp"]
F32 = ["--compute-dtype", "float32"]
SHM = ["--loader-backend", "shm"]


def _start(args, chaos=""):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DFD_CHAOS", None)
    if chaos:
        env["DFD_CHAOS"] = chaos
    return subprocess.Popen([sys.executable, "-c", _RUNNER, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=120):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _ok(r, rc=0):
    assert r.returncode == rc, \
        f"rc={r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}"


def _state(path):
    """Every tensor of a checkpoint: params and BN stats, the optimizer's
    moments, the EMA and the step counter."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"model/{k}": v for k, v in ck["state_dict"].items()}
    out.update({f"ema/{k}": v for k, v in ck["state_dict_ema"].items()})
    for i, st in ck["optimizer"]["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in st.items()})
    out["step"] = torch.tensor(ck["step"])
    return out


def _assert_bitwise(got, want, context):
    assert got.keys() == want.keys(), context
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, (context, bad[:5], len(bad))


# the first run of every case, all started at once (name: dtype flags,
# extra flags, DFD_CHAOS)
FIRST = {"ref_bf16": (AMP, [], ""), "ref_f32": (F32, [], ""),
         # SIGTERM after update 5 (epoch 0, batch 4): the synchronous
         # snapshot recovery-0-4 beside the interval's recovery-0-3
         "preempt_bf16": (AMP, [], "sigterm@5"),
         "preempt_f32": (F32, [], "sigterm@3"),
         # the shm transport: its batches are the thread transport's, so
         # the resumed run lands on the thread reference
         "preempt_shm": (AMP, SHM, "sigterm@5"),
         # batches 3, 4, 5 poisoned: the guard skips each, and the third
         # bad step in a row (read at the drain after batch 5, before that
         # batch's snapshot) rewinds to recovery-0-2, from where the span
         # replays clean (a point fires once a step)
         "nanbatch": (AMP, ["--recovery-interval", "3"], "nanbatch@3x3"),
         "stall": (AMP, ["--watchdog-timeout", "3"], "stall_loader@3:600"),
         # the epoch's last snapshot, recovery-0-5, torn after update 6;
         # the run completes, and its relaunch must fall back to
         # recovery-0-3, as the JAX test's relaunch after a hand tear does
         "torn": (AMP, [], "truncate_ckpt@6")}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_clip_tree(str(tmp_path_factory.mktemp("clips")), n_real=7,
                          n_fake=12, hw=(40, 40))


@pytest.fixture(scope="module")
def first(tree, tmp_path_factory):
    """{case: (CompletedProcess, its run directory)}, five runs at a time
    (one thread each: the suite's other workers share the cores)."""
    root = tmp_path_factory.mktemp("first")
    out, names = {}, list(FIRST)
    for i in range(0, len(names), 5):
        procs = {}
        for name in names[i:i + 5]:
            dtype, extra, chaos = FIRST[name]
            procs[name] = _start(_BASE + dtype + extra + [
                "--data", tree, "--output", str(root / name)], chaos)
        out.update({name: (_finish(p), root / name / "run")
                    for name, p in procs.items()})
    return out


@pytest.fixture(scope="module")
def reference(first):
    """The uninterrupted runs' epoch checkpoints, bf16 and f32."""
    out = {}
    for dtype in ("bf16", "f32"):
        r, run = first["ref_" + dtype]
        _ok(r)
        out[dtype] = _state(run / "checkpoint-0.pth.tar")
    return out


def _resume(run_dir, tmp_path, tree, dtype=AMP, extra=()):
    """Relaunch a copy of ``run_dir`` with the fault cleared."""
    out = tmp_path / "out"
    shutil.copytree(run_dir, out / "run")
    r = _finish(_start(_BASE + dtype + list(extra) + [
        "--data", tree, "--output", str(out)]))
    _ok(r)
    return r.stdout + r.stderr, out / "run"


def _preempted(first, name, snapshot):
    r, run = first[name]
    _ok(r, EXIT_PREEMPTED)
    assert (run / snapshot).exists(), os.listdir(run)
    assert not (run / "checkpoint-0.pth.tar").exists()
    return run


def test_sigterm_then_auto_resume_is_bitwise_uninterrupted(
        first, reference, tree, tmp_path):
    run = _preempted(first, "preempt_bf16", "recovery-0-4.pth.tar")
    assert (run / "recovery-0-3.pth.tar").exists()
    log, run = _resume(run, tmp_path, tree)
    assert "Auto-resumed from" in log and "recovery-0-4" in log
    _assert_bitwise(_state(run / "checkpoint-0.pth.tar"), reference["bf16"],
                    "bf16 preempt + auto-resume")


def test_f32_sigterm_then_auto_resume_is_bitwise_uninterrupted(
        first, reference, tree, tmp_path):
    run = _preempted(first, "preempt_f32", "recovery-0-2.pth.tar")
    log, run = _resume(run, tmp_path, tree, F32)
    assert "Auto-resumed from" in log and "recovery-0-2" in log
    _assert_bitwise(_state(run / "checkpoint-0.pth.tar"), reference["f32"],
                    "f32 preempt + auto-resume")


def test_shm_sigterm_then_auto_resume_is_bitwise_the_thread_run(
        first, reference, tree, tmp_path):
    run = _preempted(first, "preempt_shm", "recovery-0-4.pth.tar")
    log, run = _resume(run, tmp_path, tree, AMP, SHM)
    assert "Auto-resumed from" in log and "recovery-0-4" in log
    _assert_bitwise(_state(run / "checkpoint-0.pth.tar"), reference["bf16"],
                    "shm preempt + auto-resume against the thread run")


def test_torn_snapshot_falls_back_to_the_previous_one(first, reference,
                                                      tree, tmp_path):
    r, run = first["torn"]
    _ok(r)
    assert "chaos: truncated checkpoint" in r.stdout + r.stderr
    newest = run / "recovery-0-5.pth.tar"
    assert (run / "recovery-0-3.pth.tar").exists()
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint_file(str(newest))
    log, run = _resume(run, tmp_path, tree)
    assert "skipping unusable checkpoint" in log and "recovery-0-5" in log
    assert "Auto-resumed from" in log and "recovery-0-3" in log
    _assert_bitwise(_state(run / "checkpoint-0.pth.tar"), reference["bf16"],
                    "torn snapshot → fallback")


def test_nanbatch_burst_skips_then_rewinds(first, reference):
    r, run = first["nanbatch"]
    _ok(r)
    log = r.stdout + r.stderr
    assert log.count("non-finite training step") == 3, log[-3000:]
    assert "rewinding to the last recovery snapshot" in log
    assert "rewound to" in log and "recovery-0-2" in log
    _assert_bitwise(_state(run / "checkpoint-0.pth.tar"), reference["bf16"],
                    "skip + rewind")


def test_loader_stall_trips_the_watchdog(first):
    r, run = first["stall"]
    _ok(r, EXIT_WATCHDOG)
    assert "stall watchdog" in r.stderr
    assert "Thread" in r.stderr                # the all-thread stack dump
    dump = (run / "watchdog_dump.txt").read_text()
    assert "stall watchdog" in dump and "Thread" in dump
