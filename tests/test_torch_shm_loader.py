"""PyTorch port, the shm ring transport (``data/shm_ring.py``,
``--loader-backend shm``) on CPU.

* Against the JAX package: the port's ``ShmRingLoader`` over the port's clip
  dataset gives bitwise the host batches of JAX's ``ShmRingLoader`` and of
  JAX's ``HostLoader`` over the JAX dataset, on a seeded ``.npy`` tree and
  on a JPEG tree (the train chain with the collate mixup, two epochs).
* Port shm against port threads, bitwise: epochs 0 and 1 with 1, 2 and 3
  workers; the valid-mask eval; the mixup collate; ``--aug-splits 3``
  split-major; ``augment_device`` (the prologue's parameters drawn on the
  collector thread); a packed cache (its mmaps re-opened in each worker);
  ``fast_forward`` to a mid-epoch batch through the runner's loaders; the
  JPEG fallback count carried back from the workers; the ``stall_loader``
  chaos probe on the collector.
* Robustness, as JAX ``test_shm_loader.py``: a crashed worker is respawned
  with the same batches; a sample error raises ``RuntimeError`` naming the
  sample; close unlinks the segment and a second close does nothing; an
  abandoned iterator is followed by exact batches; a heartbeat stall kills
  the worker; the ring-depth floor is 3 and ``len`` is right; a ring larger
  than ``/dev/shm``'s free space raises before any worker spawns; a dataset
  that cannot cross the spawn raises and leaves no segment.
* Workers import no torch: a script whose main module imports torch starts
  a ring, and its workers' ``sys.modules`` hold neither torch nor jax.

Every test that spawns workers drains on a thread joined within
``DEADLINE`` seconds, keeps heartbeat timeouts short where a stall is
planted, and closes its loaders in ``finally``.  The misbehaving datasets
live in ``tests/torch_shm_datasets.py``, which imports neither torch nor
jax (a spawned worker imports the module of every class it unpickles).
"""

import errno
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
from multiprocessing import shared_memory
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.data import dataset as j_ds
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu_torch.data import dataset as t_ds
from deepfake_detection_tpu_torch.data import loader as t_loader
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.data import packed as t_packed
from deepfake_detection_tpu_torch.data import shm_ring
from deepfake_detection_tpu_torch.data.samplers import (OrderedShardedSampler,
                                                        ShardedTrainSampler,
                                                        epoch_batches)
from deepfake_detection_tpu_torch.runners import train as runner
from test_torch_data import make_clip_tree
import torch_shm_datasets as bad

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
DEADLINE = 60.0                 # seconds a drain may take before it fails
INPUT = (12, 32, 32)            # the clip tree's train input
JPEG_DIR = REPO / "tests" / "data" / "jpeg"


def _np(item):
    """A host batch as numpy copies: ``(images, targets[, valid])``."""
    if isinstance(item, t_loader.HostBatch):
        parts = [item.images, item.targets] + (
            [item.valid] if item.valid is not None else [])
        return tuple(p.numpy().copy() for p in parts)
    return tuple(np.array(p) for p in item)


def _bounded(fn, deadline=DEADLINE):
    """``fn()`` on a thread joined within ``deadline`` seconds."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:          # raised again below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(deadline)
    assert not t.is_alive(), f"no result within {deadline:.0f} s"
    if err:
        raise err[0]
    return out[0]


def _drain(host, epochs=(0,), n=None):
    """Each epoch's host batches (the first ``n``), copied."""
    def run():
        res = []
        for e in epochs:
            host.set_epoch(e)
            rows = []
            for item in host:
                rows.append(_np(item))
                if n is not None and len(rows) == n:
                    break
            res.append(rows)
        return res
    return _bounded(run)


def _assert_equal(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) > 0
        for ia, ib in zip(ea, eb):
            assert len(ia) == len(ib)
            for xa, xb in zip(ia, ib):
                assert xa.dtype == xb.dtype and np.array_equal(xa, xb)


def _pair(make, **kw):
    """(thread, shm) host loaders from ``make(cls, **kw)``."""
    return make(t_loader.HostLoader, **kw), make(shm_ring.ShmRingLoader,
                                                 **kw)


def _synthetic(cls, n=16, shape=(24, 24, 12), seed=7, batch=4, **kw):
    return cls(t_ds.SyntheticDataset(n, shape),
               ShardedTrainSampler(n, batch_size=batch, seed=seed), batch,
               seed=seed, **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """JPEG frames with the JAX package's decode of each as ``.npy``."""
    return make_clip_tree(str(tmp_path_factory.mktemp("shm_tree")))


@pytest.fixture(scope="module")
def jpeg_tree(tree, tmp_path_factory):
    """The same clips as JPEG only."""
    root = str(tmp_path_factory.mktemp("shm_jpeg") / "t")
    shutil.copytree(tree, root, ignore=shutil.ignore_patterns("*.npy"))
    return root


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

TRAIN_KW = dict(is_training=True, color_jitter=0.4, flicker=0.2,
                rotate_range=5, blur_radius=1, blur_prob=0.5, num_workers=2,
                seed=42)


@pytest.mark.parametrize("source", ["npy", "jpeg"])
def test_port_shm_is_bitwise_jax_shm_and_thread(tree, jpeg_tree, source):
    """The train chain with the collate mixup (host jitter, flicker, warp,
    blur, blend), two epochs of 3 batches.  The JAX dataset decodes the
    JPEGs (the ``.npy`` beside them are its own decodes, which the port
    reads on the ``npy`` tree)."""
    root = tree if source == "npy" else jpeg_tree

    def jax_loader(backend):
        return j_loader.create_deepfake_loader_v3(
            j_ds.DeepFakeClipDataset(root, label_balance=True), INPUT, 3,
            dtype=jnp.float32, loader_backend=backend,
            collate_mixup=j_mixup.FastCollateMixup(0.1, 0.1, 2), **TRAIN_KW)

    jt, js = jax_loader("thread"), jax_loader("shm")
    tl = t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(root, label_balance=True), INPUT, 3,
        device="cpu", loader_backend="shm",
        collate_mixup=t_mixup.FastCollateMixup(0.1, 0.1, 2), **TRAIN_KW)
    try:
        assert isinstance(tl.loader, shm_ring.ShmRingLoader)
        got = _drain(tl.loader, (0, 1), n=3)
        _assert_equal(got, _drain(js.loader, (0, 1), n=3))
        _assert_equal(got, _drain(jt.loader, (0, 1), n=3))
        assert got[0][0][1].dtype == np.float32            # soft targets
    finally:
        tl.close()
        js.close()
        jt.close()


# ---------------------------------------------------------------------------
# Port shm against port threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2, 3])
def test_shm_is_bitwise_thread_across_epochs(workers):
    h, s = _pair(_synthetic, num_workers=workers)
    try:
        _assert_equal(_drain(h, (0, 1)), _drain(s, (0, 1)))
    finally:
        s.close()


def test_valid_mask_eval():
    def make(cls):
        return cls(t_ds.SyntheticDataset(10, (16, 16, 12)),
                   OrderedShardedSampler(10, batch_size=4), 4, seed=3,
                   num_workers=2, valid_mask=True)
    h, s = make(t_loader.HostLoader), make(shm_ring.ShmRingLoader)
    try:
        a, b = _drain(h), _drain(s)
        _assert_equal(a, b)
        assert all(len(item) == 3 for item in b[0])
        # padded to 3 batches of 4; exactly the 10 samples are valid
        assert sum(int(item[2].sum()) for item in b[0]) == 10
    finally:
        s.close()


def test_collate_mixup():
    def make(cls):
        return _synthetic(cls, n=12, shape=(16, 16, 12), seed=5,
                          num_workers=2, collate_mixup=t_mixup
                          .FastCollateMixup(1.0, 0.1, 2))
    h, s = make(t_loader.HostLoader), make(shm_ring.ShmRingLoader)
    try:
        a, b = _drain(h, (0, 1)), _drain(s, (0, 1))
        _assert_equal(a, b)
        assert b[0][0][1].dtype == np.float32              # soft targets
    finally:
        s.close()


def _device_batches(loader, n=None):
    def run():
        loader.set_epoch(0)
        out = []
        for item in loader:
            out.append(tuple(t.numpy().copy() for t in item))
            if n is not None and len(out) == n:
                break
        return out
    return _bounded(run)


def _factory_pair(tree, **kw):
    """(thread, shm) ``create_deepfake_loader_v3`` train loaders."""
    return [t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, label_balance=True), INPUT, 2,
        device="cpu", loader_backend=b, **kw) for b in ("thread", "shm")]


def test_aug_splits_land_split_major(tree):
    """``--aug-splits 3``: each sample's three views as rows ``j``,
    ``b + j`` and ``2b + j`` of the slab, targets tiled; the normalised
    batches equal the thread backend's."""
    kw = dict(TRAIN_KW, num_aug_splits=3, re_prob=0.5, re_split=True)
    th, sh = _factory_pair(tree, **kw)
    try:
        a, b = _drain(th.loader, n=2), _drain(sh.loader, n=2)
        _assert_equal(a, b)
        assert b[0][0][0].shape == (6, 32, 32, 12)
        assert np.array_equal(b[0][0][1], np.tile(b[0][0][1][:2], 3))
        _assert_equal([_device_batches(th, 2)], [_device_batches(sh, 2)])
    finally:
        sh.close()


def test_augment_device_prologue_matches_thread(tree):
    """``augment_device``: the warp, blur, jitter and mixup blend on the
    device from parameters ``prepare`` draws on the collector thread."""
    kw = dict(TRAIN_KW, augment_device=True, re_prob=0.5)
    mix = {b: t_mixup.FastCollateMixup(0.5, 0.1, 2) for b in (0, 1)}
    th, sh = [t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, label_balance=True), INPUT, 2,
        device="cpu", loader_backend=b, collate_mixup=mix[i], **kw)
        for i, b in enumerate(("thread", "shm"))]
    try:
        assert sh.prologue.spec is not None
        _assert_equal([_device_batches(th)], [_device_batches(sh)])
    finally:
        sh.close()


def test_packed_cache(tree, tmp_path):
    """A pack's mmaps and lock do not cross the spawn: each worker opens
    the shards itself; the batches equal the thread backend's."""
    pack = str(tmp_path / "pack")
    t_packed.write_pack(tree, pack, shard_size=4, workers=2)
    ds = t_packed.PackedDataset(pack, roots=tree, label_balance=True)
    ds._shard_arrays(0)                           # an open mmap to drop
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._mmaps == {} and copy._open_lock is not None
    th, sh = [t_loader.create_deepfake_loader_v3(
        t_packed.PackedDataset(pack, roots=tree, label_balance=True),
        INPUT, 2, device="cpu", loader_backend=b, **TRAIN_KW)
        for b in ("thread", "shm")]
    try:
        _assert_equal(_drain(th.loader, (0, 1), n=3),
                      _drain(sh.loader, (0, 1), n=3))
    finally:
        sh.close()


FF_ARGS = ["--model", "efficientnet_b0", "--model-version", "",
           "--input-size-v2", "12,32,32", "-b", "2", "--label-balance",
           "--rotate-range", "5", "--blur-prob", "0.5", "--mixup", "0.2",
           "--reprob", "0.5", "--flicker", "0.1", "--workers", "2",
           "--seed", "9", "--device", "cpu", "--compute-dtype", "float32"]


def test_fast_forward_mid_epoch_through_the_runner(tree):
    """The runner's shm train loader: the tail after ``fast_forward`` is
    bitwise the thread loader's whole epoch from that batch."""
    loaders = {}
    for b in ("thread", "shm"):
        cfg = runner.parse_args(FF_ARGS + ["--data", tree,
                                           "--loader-backend", b])
        loaders[b] = runner.build_loaders(cfg, torch.device("cpu"),
                                          *runner.build_datasets(cfg))[0]
    th, sh = loaders["thread"], loaders["shm"]
    try:
        assert isinstance(sh.loader, shm_ring.ShmRingLoader)
        whole = _bounded(lambda: (th.set_epoch(1), list(th))[1])
        start = len(whole) - 2                    # a mid-epoch batch

        def tail():
            sh.set_epoch(1)
            sh.fast_forward(start)
            return list(sh)
        got = _bounded(tail)
        assert len(got) == 2 and start >= 1
        for (xa, ya), (xb, yb) in zip(got, whole[start:]):
            assert torch.equal(xa, xb) and torch.equal(ya, yb)
    finally:
        sh.close()


def test_decode_fallbacks_ride_back_in_the_ack(tmp_path):
    """A frame the decoder declines (CMYK) goes to Pillow in the worker;
    the count reaches the parent's ``decode_fallbacks``: the thread
    backend's count for the epoch plus the parent's probe clip."""
    root = tmp_path / "cmyk"
    for kind in ("real", "fake"):
        for c in range(3):
            d = root / kind / f"c{c}"
            d.mkdir(parents=True)
            for i in range(4):
                shutil.copy(JPEG_DIR / "cmyk.jpg", d / f"{i}.jpg")
        (root / f"{kind}_list.txt").write_text(
            "".join(f"c{c}:4\n" for c in range(3)))

    def counted(backend):
        tl = t_loader.create_deepfake_loader_v3(
            t_ds.DeepFakeClipDataset(str(root)), (12, 96, 96), 4,
            device="cpu", loader_backend=backend, num_workers=2,
            eval_crop="center")
        before = t_ds.decode_fallbacks
        try:
            rows = _drain(tl.loader)
        finally:
            tl.close()
        return rows, t_ds.decode_fallbacks - before

    (a, n_thread), (b, n_shm) = counted("thread"), counted("shm")
    _assert_equal(a, b)
    assert n_thread == 4 * 4 * 2                  # 2 batches of 4 clips
    assert n_shm == n_thread + 4                  # + the parent's probe


# ---------------------------------------------------------------------------
# Robustness
# ---------------------------------------------------------------------------

def test_crashed_worker_is_respawned_with_the_same_batches(tmp_path):
    sampler = ShardedTrainSampler(12, batch_size=4, seed=2)
    crash = int(epoch_batches(sampler, 4)[0][1][0])   # batch 1, not probe
    ds = bad.CrashOnce(t_ds.SyntheticDataset(12, (16, 16, 12)),
                       str(tmp_path / "crashed"), crash, os.getpid())
    s = shm_ring.ShmRingLoader(ds, sampler, 4, seed=2, num_workers=2,
                               ring_depth=3, heartbeat_timeout=10.0)
    h = _synthetic(t_loader.HostLoader, n=12, shape=(16, 16, 12), seed=2)
    try:
        _assert_equal(_drain(h), _drain(s))
        assert s.respawn_count >= 1
        assert (tmp_path / "crashed").exists()
    finally:
        s.close()


def test_sample_error_raises_naming_the_sample():
    sampler = ShardedTrainSampler(12, batch_size=4, seed=1)
    batches, _ = epoch_batches(sampler, 4)
    index = int(batches[1][2])                    # not the parent's probe
    ds = bad.RaiseOn(t_ds.SyntheticDataset(12, (16, 16, 12)), index,
                     os.getpid())
    s = shm_ring.ShmRingLoader(ds, sampler, 4, seed=1, num_workers=2,
                               heartbeat_timeout=10.0)
    try:
        with pytest.raises(RuntimeError, match=r"shm worker failed on "
                           rf"sample 2 of batch 1: ValueError: sample "
                           rf"{index} is broken"):
            _drain(s)
    finally:
        s.close()


def test_close_unlinks_the_segment_and_a_second_close_does_nothing():
    s = _synthetic(shm_ring.ShmRingLoader, n=8, shape=(16, 16, 12),
                   num_workers=2)
    _bounded(lambda: next(iter(s)))
    name = s._ring.name
    workers = list(s._workers)
    s.close()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    assert workers and all(p.exitcode is not None for p in workers)
    s.close()                                     # idempotent


def test_abandoned_iterator_then_exact_batches():
    s = _synthetic(shm_ring.ShmRingLoader, num_workers=2, seed=9)
    h = _synthetic(t_loader.HostLoader, seed=9)
    try:
        def abandon():
            for _ in s:                            # leave after one batch
                break
        _bounded(abandon)
        _assert_equal(_drain(h, (0, 1)), _drain(s, (0, 1)))
    finally:
        s.close()


def test_heartbeat_stall_kills_the_worker(tmp_path):
    """A worker silent on one task past ``heartbeat_timeout`` (1 s) is
    terminated and respawned; the task runs again and the batches are
    exact."""
    sampler = ShardedTrainSampler(12, batch_size=4, seed=4)
    index = int(epoch_batches(sampler, 4)[0][1][1])
    ds = bad.StallOnce(t_ds.SyntheticDataset(12, (16, 16, 12)),
                       str(tmp_path / "stalled"), index, 300.0,
                       os.getpid())
    s = shm_ring.ShmRingLoader(ds, sampler, 4, seed=4, num_workers=2,
                               heartbeat_timeout=1.0)
    h = _synthetic(t_loader.HostLoader, n=12, shape=(16, 16, 12), seed=4)
    try:
        _assert_equal(_drain(h), _drain(s))
        assert s.respawn_count >= 1
        assert (tmp_path / "stalled").exists()
    finally:
        s.close()


class _Unpicklable:
    """A dataset holding a lock, which cannot cross the spawn."""

    def __init__(self):
        self.base = t_ds.SyntheticDataset(8, (8, 8, 3))
        self.lock = threading.Lock()

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index, rng=None):
        return self.base.__getitem__(index, rng=rng)


def test_a_worker_that_cannot_start_raises_and_leaves_nothing():
    s = shm_ring.ShmRingLoader(_Unpicklable(),
                               ShardedTrainSampler(8, batch_size=4, seed=0),
                               4, num_workers=2)
    with pytest.raises(TypeError, match="pickle"):
        _bounded(lambda: next(iter(s)))
    assert s._ring is None and s._workers == []
    assert s._finalizer is not None and not s._finalizer.alive
    s.close()


def test_ring_depth_floor_and_len():
    s = _synthetic(shm_ring.ShmRingLoader, n=8, shape=(8, 8, 3),
                   ring_depth=1)
    assert s.ring_depth == 3
    assert len(s) == 2
    s.close()                                     # before start: a no-op


def test_ring_larger_than_dev_shm_raises_before_any_spawn():
    batch, shape = 4, (16, 16, 12)
    slab = batch * int(np.prod(shape))
    depth = shm_ring.shm_free_bytes() // slab + 1
    s = _synthetic(shm_ring.ShmRingLoader, n=8, shape=shape, batch=batch,
                   ring_depth=depth)
    try:
        with pytest.raises(OSError, match=r"needs \d+ bytes; /dev/shm has "
                           r"\d+ free") as e:
            _bounded(lambda: next(iter(s)))
        assert e.value.errno == errno.ENOSPC
        assert s._ring is None and s._workers == []
    finally:
        s.close()


_SCRIPT = r"""
import json, os, sys
import torch                          # the main module imports torch
sys.path[:0] = [{tests!r}, {repo!r}]
from deepfake_detection_tpu_torch.data.dataset import SyntheticDataset
from deepfake_detection_tpu_torch.data.samplers import ShardedTrainSampler
from deepfake_detection_tpu_torch.data.shm_ring import ShmRingLoader
import torch_shm_datasets as bad

if __name__ == "__main__":
    out = sys.argv[1]
    ds = bad.ModulesProbe(SyntheticDataset(16, (16, 16, 12)), out,
                          os.getpid())
    s = ShmRingLoader(ds, ShardedTrainSampler(16, batch_size=4, seed=0),
                      4, num_workers=2)
    try:
        n = sum(1 for _ in s)
        pids = [p.pid for p in s._workers]
    finally:
        s.close()
    print(json.dumps({{"batches": n, "pids": pids}}))
"""


def test_workers_import_no_torch(tmp_path):
    """A script whose main module imports torch starts a ring: its spawned
    workers do not run that main module again, and hold neither torch nor
    jax (nor the port's loader)."""
    script = tmp_path / "main.py"
    script.write_text(_SCRIPT.format(tests=str(REPO / "tests"),
                                     repo=str(REPO)))
    out = tmp_path / "mods"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script), str(out)],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["batches"] == 4
    mods = bad.worker_modules(str(out))
    assert set(mods) <= set(res["pids"]) and mods
    for pid, names in mods.items():
        assert "deepfake_detection_tpu_torch.data.shm_ring" in names
        leaked = sorted(n for n in names if n.split(".")[0] in (
            "torch", "jax", "jaxlib")
            or n == "deepfake_detection_tpu_torch.data.loader")
        assert not leaked, (pid, leaked[:10])


def test_stall_loader_probe_stalls_the_collector(monkeypatch):
    """``DFD_CHAOS=stall_loader@1:1.5`` stalls the shm collector before
    batch 1, as it stalls the thread backend's producer; the batches are
    unchanged."""
    h = _synthetic(t_loader.HostLoader, num_workers=2)
    want = _drain(h)
    monkeypatch.setenv("DFD_CHAOS", "stall_loader@1:1.5")
    s = _synthetic(shm_ring.ShmRingLoader, num_workers=2)
    try:
        t0 = time.monotonic()
        got = _drain(s)
        assert time.monotonic() - t0 >= 1.5
        _assert_equal(got, want)
    finally:
        s.close()
