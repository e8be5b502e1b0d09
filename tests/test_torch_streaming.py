"""PyTorch port, the streaming modules against the JAX package, on the CPU.

Per module, the port's ``streaming/`` against the JAX package's on the same
seeded inputs: the verdict machines' transitions, the tracker's track IDs
and boxes, the windower's windows and ``state_dict``, the ``FrameStack``
gathers on both wires, and ``frame_digest``, ``window_key``,
``parse_verdict_vector`` and ``split_jpeg_stream`` — all bitwise (each is
the same float64 or integer arithmetic in the same order, or a hash).
Then the port's own contracts: the engine consumes a ``FrameStack``
through ``write_into`` (one gather, pins released at staging, no ring
overflow with windows in flight), the float32 wire's window scores bitwise
the port CLI's ``--clip``, localhost round trips through
``runners.stream.build_stream_server``, the 501 for encoded frames without
Pillow, ``--device cuda`` raising without a card, and a fresh-interpreter
``runners.stream`` run that survives a SIGTERM with ``--state-dir`` and
resumes.  The model is ``efficientnet_b0`` at a 32² canvas, ``img_num`` 2,
buckets 1/4, BN calibrated by one train-mode pass (so scores are not
saturated); on the CPU the engine's programs run eagerly.
"""

import collections
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from deepfake_detection_tpu.config import StreamConfig as JStreamConfig
from deepfake_detection_tpu.params import img_mean as j_img_mean
from deepfake_detection_tpu.params import img_std as j_img_std
from deepfake_detection_tpu.streaming import ingest as j_ingest
from deepfake_detection_tpu.streaming import ring as j_ring
from deepfake_detection_tpu.streaming import tracker as j_tracker
from deepfake_detection_tpu.streaming import verdict as j_verdict
from deepfake_detection_tpu.streaming import windows as j_windows
from deepfake_detection_tpu_torch.csrc import build as kernels
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.params import (img_mean, img_std,
                                                 normalize_concat,
                                                 prepare_canvas)
from deepfake_detection_tpu_torch.runners import stream as stream_runner
from deepfake_detection_tpu_torch.runners import test as cli
from deepfake_detection_tpu_torch.serving.batcher import MicroBatcher
from deepfake_detection_tpu_torch.serving.config import StreamConfig
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from deepfake_detection_tpu_torch.streaming import ingest, ring, tracker
from deepfake_detection_tpu_torch.streaming import verdict, windows
from deepfake_detection_tpu_torch.streaming.metrics import StreamingMetrics

torch.set_num_threads(2)

pytestmark = pytest.mark.streaming

REPO = Path(__file__).resolve().parent.parent
MODEL = "efficientnet_b0"
SIZE = 32
NUM = 2
BUCKETS = (1, 4)
TIMEOUT = 30


def _frames(n, h=48, w=40, seed=0):
    """Seeded uint8 frames, not canvas-sized (resize and pad both run)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def calibrated_state(num: int = NUM, size: int = SIZE) -> dict:
    """``efficientnet_b0`` with ``3*num`` input channels, BN running stats
    set by one train-mode pass over 48 seeded clips of the serving
    preprocess (so P(fake) is neither 0.5 nor saturated)."""
    model = create_model(MODEL, num_classes=2, in_chans=3 * num,
                         bn_momentum=1.0, device="cpu")
    rng = np.random.default_rng(0)
    x = np.stack([normalize_concat(
        [rng.integers(0, 256, (size, size, 3), np.uint8)
         for _ in range(num)]) for _ in range(48)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _model(sd, num=NUM):
    m = create_model(MODEL, num_classes=2, in_chans=3 * num, device="cpu")
    m.load_state_dict(sd)
    return m.eval()


@pytest.fixture(scope="module")
def state():
    return calibrated_state()


# ---------------------------------------------------------------------------
# per-module parity with the JAX package
# ---------------------------------------------------------------------------

def test_verdict_constants_are_the_jax_ones():
    assert verdict.SEVERITY == j_verdict.SEVERITY
    assert verdict.EVENT_SCHEMA == j_verdict.EVENT_SCHEMA == \
        "dfd.streaming.verdict.v1"
    assert verdict.VerdictThresholds().to_dict() == \
        j_verdict.VerdictThresholds().to_dict()


@pytest.mark.parametrize("bad", [(0.5, 0.5, 0.8, 0.65), (0.5, 0.35, 0.8,
                                                          0.9),
                                 (0.9, 0.35, 0.8, 0.65),
                                 (0.5, 0.7, 0.8, 0.65), (1.2, 0.3, 1.3, 1.0)])
def test_verdict_threshold_validation_matches_jax(bad):
    with pytest.raises(ValueError) as want:
        j_verdict.VerdictThresholds(*bad)
    with pytest.raises(ValueError) as got:
        verdict.VerdictThresholds(*bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,alpha,min_windows",
                         [(0, 0.3, 1), (1, 0.6, 1), (2, 0.3, 3), (3, 1.0, 1)])
def test_verdict_transitions_match_jax(seed, alpha, min_windows):
    """Seeded score walks through every band: the same events (bitwise,
    wall time pinned) and the same full-precision state."""
    rng = np.random.default_rng(seed)
    scores = np.clip(np.cumsum(rng.normal(0, 0.25, 200)) * 0.2 + 0.5
                     + rng.normal(0, 0.1, 200), 0, 1)
    ctx = {"stream_id": "s", "scope": "stream"}
    vm = verdict.VerdictMachine(ema_alpha=alpha, min_windows=min_windows,
                                context=ctx)
    jm = j_verdict.VerdictMachine(ema_alpha=alpha, min_windows=min_windows,
                                  context=ctx)
    events = 0
    for i, s in enumerate(scores):
        got = vm.update(float(s), frame_idx=i, wall_time=0.0)
        want = jm.update(float(s), frame_idx=i, wall_time=0.0)
        assert got == want
        events += len(got)
    assert events >= 2                   # the walk really moved
    assert vm.state_dict() == jm.state_dict()
    assert vm.snapshot() == jm.snapshot()


def _detections(rng, t, faces):
    """Seeded detector output at frame ``t``: jittered moving boxes, some
    missed, plus an occasional false positive."""
    dets = []
    for k, (x, y, vx, vy) in enumerate(faces):
        if rng.random() < 0.15:
            continue                                 # a missed detection
        cx, cy = x + vx * t, y + vy * t
        j = rng.normal(0, 2.0, 4)
        dets.append(((cx + j[0], cy + j[1], cx + 40 + j[2], cy + 50 + j[3]),
                     float(rng.uniform(0.5, 1.0))))
    if rng.random() < 0.1:
        x, y = rng.uniform(0, 200, 2)
        dets.append(((x, y, x + 20, y + 20), 0.3))
    return dets


@pytest.mark.parametrize("seed,min_hits,max_coast",
                         [(0, 1, 10), (1, 2, 2), (2, 1, 0), (3, 3, 4)])
def test_tracker_matches_jax(seed, min_hits, max_coast):
    rng = np.random.default_rng(seed)
    faces = [(rng.uniform(0, 150), rng.uniform(0, 100), rng.uniform(-2, 2),
              rng.uniform(-1, 1)) for _ in range(3)]
    kw = dict(iou_min=0.3, ema_alpha=0.6, max_coast=max_coast,
              min_hits=min_hits)
    pt, jt = tracker.GreedyIouTracker(**kw), j_tracker.GreedyIouTracker(**kw)
    for t in range(60):
        dets = _detections(rng, t, faces)
        a, b = pt.update(t, dets), jt.update(t, dets)
        for part in ("matched", "born", "coasting", "died", "fresh"):
            assert [(x.id, x.box) for x in getattr(a, part)] == \
                [(x.id, x.box) for x in getattr(b, part)], (t, part)
    assert pt.born_total > 3                 # births, coasts and deaths ran
    assert pt.died_total > 0 or max_coast == 10
    assert pt.state_dict() == jt.state_dict()
    assert pt.snapshot() == jt.snapshot()


def test_crop_box_and_iou_match_jax():
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for _ in range(200):
        box = tuple(rng.uniform(-10, 70, 4))
        other = tuple(rng.uniform(-10, 70, 4))
        margin = float(rng.choice([0.0, 0.15, 0.5]))
        np.testing.assert_array_equal(
            tracker.crop_box(frame, box, margin),
            j_tracker.crop_box(frame, box, margin))
        assert tracker.iou(box, other) == j_tracker.iou(box, other)
    assert tracker.make_localizer("full_frame").localize(frame) == \
        j_tracker.make_localizer("full_frame").localize(frame)
    with pytest.raises(ValueError, match="unknown localizer"):
        tracker.make_localizer("nope")


def test_digests_and_window_keys_bitwise():
    rng = np.random.default_rng(6)
    arrays = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
              rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)[::2, 1:],
              rng.standard_normal((8, 8, 6)).astype(np.float32),
              np.zeros((1, 1, 3), np.uint8)]
    digests = []
    for a in arrays:
        d = ring.frame_digest(a)
        assert d == j_ring.frame_digest(a)
        digests.append(d)
    for k in range(1, len(digests) + 1):
        assert ring.window_key(digests[:k]) == j_ring.window_key(digests[:k])
    assert ring.window_key(digests[:2]) != ring.window_key(digests[1::-1])


@pytest.mark.parametrize("spec", ["", "0.05*8,0.95*12", "0.5", " 0.1 , 0.2*3 ,",
                                  "1*2,0*2", "1.5", "0.2*x"])
def test_parse_verdict_vector_matches_jax(spec):
    try:
        want = j_ingest.parse_verdict_vector(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ingest.parse_verdict_vector(spec)
        assert str(got.value) == str(e)
        return
    assert ingest.parse_verdict_vector(spec) == want


def test_split_jpeg_stream_matches_jax():
    rng = np.random.default_rng(7)
    bodies = [b"", b"\xff\xd8abc\xff\xd9", b"junk\xff\xd8a\xff\xd9\xff\xd8",
              b"\xff\xd8\xff\xd9\xff\xd8xx\xff\xd9tail"]
    for _ in range(20):
        parts = [b"\xff\xd8" + rng.integers(0, 255, int(rng.integers(0, 50)),
                                            dtype=np.uint8).tobytes()
                 .replace(b"\xff", b"\xfe") + b"\xff\xd9"
                 for _ in range(int(rng.integers(0, 5)))]
        bodies.append(rng.bytes(int(rng.integers(0, 9))).join(parts))
    for body in bodies:
        assert ingest.split_jpeg_stream(body) == \
            j_ingest.split_jpeg_stream(body)


@pytest.mark.parametrize("img_num,stride,hop", [(2, 1, 0), (4, 1, 2),
                                                (3, 2, 1), (2, 2, 5)])
def test_windower_matches_jax(img_num, stride, hop):
    """Two tracks, one dropped midway: the same windows (indices, frames,
    digests) and the same ``state_dict``; each package's snapshot loads
    into the other and both continue alike."""
    frames = [prepare_canvas(f, SIZE) for f in _frames(30, seed=8)]
    digests = [ring.frame_digest(f) for f in frames]
    pw = windows.TrackWindower(img_num, stride=stride, hop=hop)
    jw = j_windows.TrackWindower(img_num, stride=stride, hop=hop)

    def push(w, tid, i):
        return w.push(tid, i, frames[i], digest=digests[i])

    def same(a, b):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.track_id, a.frame_idxs, a.window_idx, a.digests) == \
                (b.track_id, b.frame_idxs, b.window_idx, b.digests)
            for x, y in zip(a.frames, b.frames):
                np.testing.assert_array_equal(x, y)

    emitted = 0
    for i in range(20):
        for tid in (0, 1):
            if tid == 1 and i == 12:
                pw.drop_track(1)
                jw.drop_track(1)
            if tid == 1 and i >= 12:
                continue
            a, b = push(pw, tid, i), push(jw, tid, i)
            same(a, b)
            emitted += a is not None
    assert emitted > 3
    assert pw.state_dict() == jw.state_dict()
    # cross-load the snapshots (JSON, as the state dir writes them)
    pw2 = windows.TrackWindower(img_num, stride=stride, hop=hop,
                                digest_frames=True)
    jw2 = j_windows.TrackWindower(img_num, stride=stride, hop=hop,
                                  digest_frames=True)
    pw2.load_state_dict(json.loads(json.dumps(jw.state_dict())))
    jw2.load_state_dict(json.loads(json.dumps(pw.state_dict())))
    for i in range(20, 30):
        same(push(pw2, 0, i), push(jw2, 0, i))
    assert pw2.state_dict() == jw2.state_dict()


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_framestack_gather_matches_jax(wire):
    """The gather out of a ring, port against JAX, and against both
    packages' ``build_payload`` (the standalone concat path): bitwise."""
    canv = [prepare_canvas(f, SIZE) for f in _frames(4, seed=9)]
    r = ring.CanvasRing(8, SIZE)
    refs = [r.acquire() for _ in canv]
    for ref, c in zip(refs, canv):
        ref.canvas[...] = c
    views = [ref.canvas for ref in refs]
    norm = (img_mean, img_std) if wire == "float32" else None
    j_norm = (j_img_mean, j_img_std) if wire == "float32" else None
    ps, js = ring.FrameStack(views, norm=norm), \
        j_ring.FrameStack(views, norm=j_norm)
    assert (ps.shape, ps.ndim, ps.dtype) == (js.shape, js.ndim, js.dtype)
    got, want = np.empty(ps.shape, ps.dtype), np.empty(js.shape, js.dtype)
    ps.write_into(got)
    js.write_into(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, windows.build_payload(views, wire))
    np.testing.assert_array_equal(got, j_windows.build_payload(views, wire))
    np.testing.assert_array_equal(ps.materialize(), got)


def test_stream_config_flags_match_jax(tmp_path):
    """Every JAX ``StreamConfig`` field, with its default; the port adds
    ``--device`` (cuda by default); the XLA-only and warm-start flags
    raise, as in the port's ``ServeConfig``."""
    port = {f.name: f.default for f in dataclasses.fields(StreamConfig)}
    jax_ = {f.name: f.default for f in dataclasses.fields(JStreamConfig)}
    assert set(port) - set(jax_) == {"device"}
    assert {k: port[k] for k in jax_} == jax_
    assert StreamConfig().device == "cuda" and StreamConfig().port == 8378
    cfg = StreamConfig.from_args(["--window-hop", "2", "--dedup-frames",
                                  "--buckets", "1,4", "--device", "cpu"])
    assert (cfg.window_hop, cfg.dedup_frames, cfg.buckets) == (2, True,
                                                              (1, 4))
    for flag in (["--compile-cache-dir", "x"], ["--single-thread-xla"]):
        with pytest.raises(NotImplementedError):
            StreamConfig.from_args(flag)
    # item 10 is ported: the stream server's engine attaches the store
    store = str(tmp_path / "ws")
    srv = stream_runner.build_stream_server(StreamConfig.from_args(
        ["--warmstart-dir", store, "--device", "cpu", "--model", MODEL,
         "--image-size", str(SIZE), "--img-num", str(NUM), "--buckets", "1",
         "--port", "0"]))
    try:
        assert srv.engine.warmstart.root == store
        assert srv.engine.metrics.warmstart_serialized_total.value == 1
    finally:
        kernels.set_store(None)
        srv.manager.shutdown()
        srv.batcher.close()
        srv.server_close()
    for bad in (["--fake-enter", "0.4"], ["--verdict-ema-alpha", "0"],
                ["--assembly", "x"], ["--window-hop", "-1"]):
        with pytest.raises(ValueError):
            StreamConfig.from_args(bad)


# ---------------------------------------------------------------------------
# the engine consumes a FrameStack through write_into
# ---------------------------------------------------------------------------

class _CountingStack(ring.FrameStack):
    """A FrameStack that counts the calls that would materialize it."""

    calls = collections.Counter()

    def materialize(self):
        _CountingStack.calls["materialize"] += 1
        return super().materialize()

    def __array__(self, dtype=None, copy=None):
        _CountingStack.calls["__array__"] += 1
        return super().__array__(dtype)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_engine_gathers_framestack_once_and_releases_pins(state, wire):
    """``_pad_batch`` calls ``write_into`` (the one gather), never
    ``__array__`` or ``materialize``; the ring's rows are all free again
    once the batch is staged; the scores equal the materialized clip's."""
    eng = InferenceEngine(_model(state), image_size=SIZE, img_num=NUM,
                          buckets=BUCKETS, wire=wire)
    r = ring.CanvasRing(2 * NUM, SIZE)
    stacks, clips = [], []
    for k in range(2):
        refs = [r.acquire() for _ in range(NUM)]    # buffer's reference
        for ref, f in zip(refs, _frames(NUM, seed=20 + k)):
            ref.canvas[...] = prepare_canvas(f, SIZE)
            ref.incref()                            # the window's pin
            ref.decref()                            # the buffer moved on
        lease = ring.RingLease(refs)
        norm = (img_mean, img_std) if wire == "float32" else None
        stacks.append(_CountingStack([ref.canvas for ref in refs],
                                     norm=norm, on_consumed=lease.release))
        clips.append(stacks[-1].materialize())
    assert r.free_rows() == 0
    _CountingStack.calls.clear()
    got = eng.score_batch(stacks)
    assert dict(_CountingStack.calls) == {}
    assert r.free_rows() == r.capacity and r.overflow_total == 0
    np.testing.assert_array_equal(got, eng.score_batch(clips))


def test_inflight_windows_release_pins_at_staging(state):
    """``max_inflight_windows`` windows queued before the engine starts,
    then staged as one batch whose program blocks: while they are in
    flight every ring row but the windower's own buffer is free (the pins
    went at staging, not at the result), the ring never overflowed, and
    the books balance once the batch completes."""
    cfg = StreamConfig(model=MODEL, image_size=SIZE, img_num=NUM,
                       buckets=BUCKETS, device="cpu", stream_ttl_s=0.0,
                       max_inflight_windows=4, batch_deadline_ms=50.0)
    eng = InferenceEngine(_model(state), image_size=SIZE, img_num=NUM,
                          buckets=BUCKETS, wire=cfg.wire)
    batcher = MicroBatcher(max_batch=4, deadline_ms=cfg.batch_deadline_ms,
                           max_queue=64, metrics=eng.metrics)
    box = []
    disp = windows.WindowDispatcher(
        batcher, max_pending=cfg.max_inflight_windows,
        on_result=lambda j, s, e: box[0].on_result(j, s, e),
        on_drop=lambda j, r_: box[0].on_drop(j, r_))
    manager = ingest.StreamManager(cfg, disp, StreamingMetrics(),
                                   image_size=SIZE, wire=cfg.wire)
    box.append(manager)
    prog = eng.entry().compiled[(4, 3 * NUM)]
    entered, release = threading.Event(), threading.Event()
    fn = prog.fn

    def blocking(x):
        entered.set()
        assert release.wait(TIMEOUT)
        return fn(x)

    prog.fn = blocking
    disp.start()
    try:
        s = manager.create("inflight")
        s.ingest_arrays(_frames(2 * cfg.max_inflight_windows, seed=30))
        assert s.windows_emitted == cfg.max_inflight_windows
        deadline = time.monotonic() + TIMEOUT
        while batcher.depth < cfg.max_inflight_windows:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        eng.start(batcher)
        assert entered.wait(TIMEOUT)
        rg = s._rings[0]
        assert rg.free_rows() == rg.capacity - s.windower.span
        assert rg.overflow_total == 0
        assert manager.metrics.ring_overflow_total.value == 0
        release.set()
        while s.windows_scored < cfg.max_inflight_windows:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        c = s.status()["counters"]
        assert c["windows_emitted"] == c["windows_scored"] + \
            c["windows_dropped"] + c["windows_shed"] + c["windows_failed"] \
            + c["windows_cache_hit"] + c["windows_dup_elided"]
        assert c["windows_dropped"] == 0
    finally:
        release.set()
        manager.shutdown()
        disp.stop()
        eng.stop()
        batcher.close()


# ---------------------------------------------------------------------------
# the port's own contracts: CLI parity, HTTP, the runner
# ---------------------------------------------------------------------------

def test_float32_window_scores_bitwise_cli_clip(tmp_path, monkeypatch):
    """A streamed window on the float32 wire scores bitwise what the port
    CLI's ``test_img(..., clip=True)`` gives the same four frames (the
    CLI's clip width, ``img_num`` 4; its model factory patched to this
    test's ``efficientnet_b0``)."""
    sd = calibrated_state(num=4)
    ckpt = tmp_path / "b0.pth"
    torch.save(sd, ckpt)
    monkeypatch.setattr(cli, "create_deepfake_model_v4",
                        lambda *a, **k: create_model(
                            MODEL, num_classes=2, in_chans=12,
                            device=k.get("device", "cpu")))
    frames = _frames(8, seed=40)
    files = []
    for i, f in enumerate(frames):
        files.append(str(tmp_path / f"{i}.npy"))
        np.save(files[-1], f)
    want = cli.test_img(str(ckpt), files, size=SIZE, clip=True,
                        device="cpu")
    cfg = StreamConfig(model=MODEL, model_path=str(ckpt), image_size=SIZE,
                       img_num=4, buckets=BUCKETS, device="cpu", port=0,
                       stream_ttl_s=0.0)
    srv = stream_runner.build_stream_server(cfg)
    got = []
    srv.dispatcher._on_result = lambda j, sc, e: got.append(
        (j.window_idx, float(sc[0])))
    srv.engine.start(srv.batcher)
    srv.dispatcher.start()
    try:
        s = srv.manager.create("clip")
        deadline = time.monotonic() + TIMEOUT
        for k in range(2):          # one window a batch, as the CLI scores
            s.ingest_arrays(frames[4 * k:4 * k + 4])
            while len(got) <= k and time.monotonic() < deadline:
                time.sleep(0.01)
        assert [sc for _, sc in sorted(got)] == want
    finally:
        srv.dispatcher.stop()
        srv.manager.shutdown()
        srv.engine.stop()
        srv.batcher.close()
        srv.server_close()


@pytest.fixture(scope="module")
def http_stack(state, tmp_path_factory):
    """``build_stream_server`` on the CPU from a checkpoint file, started
    on an ephemeral localhost port."""
    ckpt = tmp_path_factory.mktemp("ckpt") / "b0.pth"
    torch.save(state, ckpt)
    cfg = StreamConfig(model=MODEL, model_path=str(ckpt), image_size=SIZE,
                       img_num=NUM, buckets=BUCKETS, device="cpu", port=0,
                       stream_ttl_s=0.0, max_inflight_windows=16)
    srv = stream_runner.build_stream_server(cfg)
    srv.engine.start(srv.batcher)
    srv.dispatcher.start()
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.1},
                     daemon=True).start()
    yield srv
    srv.shutdown()
    srv.dispatcher.stop()
    srv.manager.shutdown()
    srv.engine.stop()
    srv.batcher.close()
    srv.server_close()


def _req(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def _raw(frames):
    h, w = frames[0].shape[:2]
    return (b"".join(np.ascontiguousarray(f).tobytes() for f in frames),
            {"Content-Type": "application/x-dfd-raw",
             "X-Frame-Width": str(w), "X-Frame-Height": str(h)})


def _wait_scored(port, sid, n):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        st = _req(port, "GET", f"/streams/{sid}")[1]
        if st["counters"]["windows_scored"] >= n:
            return st
        time.sleep(0.02)
    raise AssertionError(f"stream {sid} never scored {n} windows: {st}")


def test_localhost_round_trips(http_stack):
    port = http_stack.server_address[1]
    assert _req(port, "GET", "/healthz") == (200, "ok\n")
    st, ready = _req(port, "GET", "/readyz")
    assert st == 200 and ready["ready"] is True
    st, opened = _req(port, "POST", "/streams",
                      json.dumps({"stream_id": "rt"}).encode(),
                      {"Content-Type": "application/json"})
    assert (st, opened) == (201, {"stream_id": "rt"})
    assert _req(port, "POST", "/streams", b'{"stream_id": "rt"}')[0] == 409
    body, headers = _raw(_frames(5, seed=50))
    st, ack = _req(port, "POST", "/streams/rt/frames", body, headers)
    assert st == 200
    assert (ack["frames_accepted"], ack["windows_emitted"],
            ack["decode_errors"], ack["stream_id"]) == (5, 2, 0, "rt")
    status = _wait_scored(port, "rt", 2)
    assert status["schema"] == "dfd.streaming.status.v1"
    assert status["counters"]["frames_ingested"] == 5
    assert 0.0 <= status["stream"]["last_score"] <= 1.0
    assert _req(port, "GET", "/streams")[1] == {"streams": ["rt"],
                                                "active": 1}
    st, text = _req(port, "GET", "/metrics")
    assert st == 200 and "dfd_streaming_windows_scored_total" in text \
        and "dfd_serving_" in text
    assert _req(port, "POST", "/streams/rt/frames", b"x" * 7, headers)[0] \
        == 400
    # migrate out and restore in over HTTP
    st, snap = _req(port, "POST", "/streams/rt/migrate")
    assert st == 200 and snap["schema"] == "dfd.streaming.session_state.v1"
    assert _req(port, "GET", "/streams/rt")[0] == 404
    st, back = _req(port, "POST", "/streams/restore",
                    json.dumps(snap).encode())
    assert st == 201 and back["windows_scored"] == 2
    st, final = _req(port, "DELETE", "/streams/rt")
    assert st == 200 and final["closed"] is True
    assert _req(port, "DELETE", "/streams/rt")[0] == 404


def _jpeg(frame):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def test_encoded_chunks_501_without_pillow(http_stack, monkeypatch):
    """With Pillow's import failing, an encoded chunk answers 501 naming
    the raw wire, counts no decode error, and the raw wire still works;
    with Pillow back, undecodable bytes count as decode errors."""
    port = http_stack.server_address[1]
    _req(port, "POST", "/streams", b'{"stream_id": "enc"}')
    good = _jpeg(_frames(1, seed=60)[0])
    multipart = (b"--f\r\nContent-Type: image/jpeg\r\n\r\n" + good
                 + b"\r\n--f--\r\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for body, ctype in ((good, "image/jpeg"), (good,
                                               "application/octet-stream"),
                        (multipart, "multipart/x-mixed-replace; "
                                    "boundary=f")):
        st, out = _req(port, "POST", "/streams/enc/frames", body,
                       {"Content-Type": ctype})
        assert st == 501 and "application/x-dfd-raw" in out["error"], out
    body, headers = _raw(_frames(2, seed=61))
    assert _req(port, "POST", "/streams/enc/frames", body, headers)[0] == 200
    assert _req(port, "GET", "/streams/enc")[1]["counters"][
        "decode_errors"] == 0
    monkeypatch.delitem(sys.modules, "PIL")
    body = (b"--f\r\nContent-Type: image/jpeg\r\n\r\n" + good + b"\r\n"
            b"--f\r\nContent-Type: image/jpeg\r\n\r\nNOT A JPEG\r\n--f--\r\n")
    st, ack = _req(port, "POST", "/streams/enc/frames", body,
                   {"Content-Type": "multipart/x-mixed-replace; boundary=f"})
    assert st == 200 and (ack["frames_accepted"], ack["decode_errors"]) \
        == (1, 1)
    _req(port, "DELETE", "/streams/enc")


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is served there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_runner.build_stream_server(StreamConfig(
            model=MODEL, image_size=SIZE, img_num=NUM, buckets=BUCKETS))
    switch = sys.getswitchinterval()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            stream_runner.main(["--model", MODEL, "--image-size", str(SIZE),
                                "--img-num", str(NUM), "--buckets", "1,4",
                                "--port", "0"])
    finally:
        sys.setswitchinterval(switch)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(ckpt, state_dir, port, log):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "deepfake_detection_tpu_torch.runners.stream",
         "--model", MODEL, "--model-path", str(ckpt), "--image-size",
         str(SIZE), "--img-num", str(NUM), "--buckets", "1,4", "--port",
         str(port), "--device", "cpu", "--state-dir", str(state_dir),
         "--stream-ttl-s", "0", "--verdict-vector", "0.05*1,0.95*8"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)


def _wait_ready(proc, port, log):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        assert proc.poll() is None, Path(log.name).read_text()[-3000:]
        try:
            if _req(port, "GET", "/readyz")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("the stream runner never became ready")


def test_runner_sigterm_snapshot_and_resume(state, tmp_path):
    """A fresh interpreter: two streams scored, SIGTERM → exit 0 with one
    snapshot each; the relaunch restores both, and their next windows
    continue the window count and the verdict machines (the planted
    vector's third window crosses into 'suspect', which a reset machine
    would not)."""
    ckpt, sdir = tmp_path / "b0.pth", tmp_path / "state"
    torch.save(state, ckpt)
    port = _free_port()
    log = open(tmp_path / "stream.log", "w")
    proc = _launch(ckpt, sdir, port, log)
    try:
        _wait_ready(proc, port, log)
        for sid, seed in (("a", 70), ("b", 71)):
            _req(port, "POST", "/streams",
                 json.dumps({"stream_id": sid}).encode())
            body, headers = _raw(_frames(3, seed=seed))
            _req(port, "POST", f"/streams/{sid}/frames", body, headers)
            _wait_scored(port, sid, 1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert sorted(p.name for p in sdir.iterdir()) == ["a.state.json",
                                                      "b.state.json"]
    proc = _launch(ckpt, sdir, port, log)
    try:
        _wait_ready(proc, port, log)
        assert _req(port, "GET", "/streams")[1]["streams"] == ["a", "b"]
        assert list(sdir.iterdir()) == []        # snapshots consumed
        for sid, seed in (("a", 72), ("b", 73)):
            st = _req(port, "GET", f"/streams/{sid}")[1]
            assert st["counters"]["frames_ingested"] == 3
            assert st["counters"]["windows_scored"] == 1
            body, headers = _raw(_frames(3, seed=seed))
            _, ack = _req(port, "POST", f"/streams/{sid}/frames", body,
                          headers)
            assert ack["windows_emitted"] == 2     # the half window + one
            st = _wait_scored(port, sid, 3)
            assert st["stream"]["windows"] == 3
            assert [(e["from"], e["to"], e["windows"]) for e in st["events"]
                    if e["scope"] == "stream"] == [("real", "suspect", 3)]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.close()
