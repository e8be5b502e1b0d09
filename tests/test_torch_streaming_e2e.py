"""PyTorch port, the streaming pipeline against the JAX package's, on the CPU.

The port's ``StreamManager`` over a CPU port engine and the JAX
``StreamManager`` over the JAX engine, each behind its own localhost
stream server, get the same frames: raw uint8 chunks, and (Pillow being
here) a multipart JPEG chunk.  Tolerances: window scores within 1e-5
(f32 through ``efficientnet_b0``, summed in other orders by XLA and torch;
the int8 case realizes the same quantized weights on both sides), decoded
JPEG frames within one grey level (the JAX package decodes through its
native libjpeg pool where it is built, the port through Pillow; the most
seen on the CPU box with the pool built is 0); verdict
events (timestamps aside), books and window indices equal.  A session
exported, or snapshotted to a state dir, by either package resumes in the
other and both go on alike.
"""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from deepfake_detection_tpu.config import StreamConfig as JStreamConfig
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.serving.batcher import \
    MicroBatcher as JMicroBatcher
from deepfake_detection_tpu.serving.engine import \
    InferenceEngine as JInferenceEngine
from deepfake_detection_tpu.serving.metrics import \
    ServingMetrics as JServingMetrics
from deepfake_detection_tpu.streaming import ingest as j_ingest
from deepfake_detection_tpu.streaming.metrics import \
    StreamingMetrics as JStreamingMetrics
from deepfake_detection_tpu.streaming.windows import \
    WindowDispatcher as JWindowDispatcher
from deepfake_detection_tpu_torch.serving.batcher import MicroBatcher
from deepfake_detection_tpu_torch.serving.config import StreamConfig
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from deepfake_detection_tpu_torch.serving.metrics import ServingMetrics
from deepfake_detection_tpu_torch.streaming import ingest
from deepfake_detection_tpu_torch.streaming.metrics import StreamingMetrics
from deepfake_detection_tpu_torch.streaming.windows import WindowDispatcher
from test_torch_streaming import (BUCKETS, MODEL, NUM, SIZE, TIMEOUT, _frames,
                                  _jpeg, _model, _raw, _req,
                                  calibrated_state)
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

pytestmark = pytest.mark.streaming

TOL = 1e-5
PLANTED = "0.05*2,0.99*5,0.05*4"
BOOKS = ("windows_emitted", "windows_scored", "windows_dropped",
         "windows_shed", "windows_failed", "windows_cache_hit",
         "windows_dup_elided")


class _Side:
    """One package's stream stack: engine → batcher → dispatcher →
    manager → localhost HTTP, with every window's scores recorded."""

    def __init__(self, engine, batcher, serving_metrics, cfg, mod,
                 dispatcher_cls, metrics_cls):
        self.engine, self.batcher = engine, batcher
        self.scores = {}                  # (stream, track, window) → P(fake)
        box = []

        def on_result(job, scores, error):
            if scores is not None:
                self.scores[(job.stream_id, job.track_id,
                             job.window_idx)] = float(scores[0])
            box[0].on_result(job, scores, error)

        self.dispatcher = dispatcher_cls(
            batcher, max_pending=cfg.max_inflight_windows,
            request_timeout_s=TIMEOUT, on_result=on_result,
            on_drop=lambda j, r: box[0].on_drop(j, r))
        self.manager = mod.StreamManager(cfg, self.dispatcher, metrics_cls(),
                                         image_size=SIZE, wire=cfg.wire)
        box.append(self.manager)
        engine.start(batcher)
        self.dispatcher.start()
        self.server = mod.make_stream_server("127.0.0.1", 0, self.manager,
                                             engine, serving_metrics,
                                             self.manager.metrics)
        threading.Thread(target=self.server.serve_forever,
                         kwargs={"poll_interval": 0.1}, daemon=True).start()
        self.port = self.server.server_address[1]

    def wait(self, sid, n):
        s = self.manager.get(sid)
        deadline = time.monotonic() + TIMEOUT
        while s.windows_scored < n:
            assert time.monotonic() < deadline, (sid, s.status())
            time.sleep(0.01)
        return s

    def close(self):
        self.server.shutdown()
        self.dispatcher.stop()
        self.manager.shutdown()
        self.engine.stop()
        self.batcher.close()
        self.server.server_close()


@pytest.fixture(scope="module")
def weights():
    sd = calibrated_state()
    return sd, convert_state_dict({k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module", params=["f32", "int8"])
def pair(request, weights):
    """(port side, JAX side) at the served dtype ``request.param``."""
    sd, jv = weights
    kw = dict(image_size=SIZE, img_num=NUM, buckets=BUCKETS,
              stream_ttl_s=0.0, max_inflight_windows=16,
              verdict_vector=PLANTED, dtype=request.param)
    sm = ServingMetrics()
    port = _Side(InferenceEngine(_model(sd), image_size=SIZE, img_num=NUM,
                                 buckets=BUCKETS, metrics=sm,
                                 dtype=request.param),
                 MicroBatcher(max_batch=4, deadline_ms=5.0, max_queue=64,
                              metrics=sm), sm,
                 StreamConfig(device="cpu", **kw), ingest, WindowDispatcher,
                 StreamingMetrics)
    jsm = JServingMetrics()
    ref = _Side(JInferenceEngine(j_create_model(MODEL, num_classes=2,
                                                in_chans=3 * NUM), jv,
                                 image_size=SIZE, img_num=NUM,
                                 buckets=BUCKETS, metrics=jsm,
                                 dtype=request.param),
                JMicroBatcher(max_batch=4, deadline_ms=5.0, max_queue=64,
                              metrics=jsm), jsm,
                JStreamConfig(**kw), j_ingest, JWindowDispatcher,
                JStreamingMetrics)
    yield port, ref
    port.close()
    ref.close()


def _events(status):
    return [{k: v for k, v in e.items() if k != "wall_time"}
            for e in status["events"]]


def _same_scores(port, ref, keys, tol=TOL):
    got = np.asarray([port.scores[k] for k in keys])
    want = np.asarray([ref.scores[k] for k in keys])
    assert np.abs(want - 0.5).max() > 1e-3            # not degenerate
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_session_scores_events_books_match_jax(pair):
    """Raw chunks of 1, 3, 5 and 9 frames at 48×40: the same windows,
    scores within 1e-5, the planted vector's events and the 6-term books
    equal."""
    port, ref = pair
    frames = _frames(18, seed=80)
    for side in (port, ref):
        assert _req(side.port, "POST", "/streams",
                    b'{"stream_id": "par"}')[0] == 201
        at = 0
        for n in (1, 3, 5, 9):
            body, headers = _raw(frames[at:at + n])
            st, ack = _req(side.port, "POST", "/streams/par/frames", body,
                           headers)
            assert st == 200 and ack["frames_accepted"] == n
            at += n
        side.wait("par", 9)
    keys = sorted(k for k in ref.scores if k[0] == "par")
    assert keys == sorted(k for k in port.scores if k[0] == "par")
    assert len(keys) == 9
    _same_scores(port, ref, keys)
    ps, js = (side.manager.get("par").status(events=64)
              for side in (port, ref))
    assert _events(ps) == _events(js) and len(_events(ps)) >= 3
    assert ps["verdict"] == js["verdict"]
    assert ps["counters"] == js["counters"]
    c = ps["counters"]
    assert c["windows_emitted"] == sum(c[k] for k in BOOKS[1:])
    for side in (port, ref):
        _req(side.port, "DELETE", "/streams/par")


@pytest.mark.parametrize("pair", ["f32"], indirect=True)
def test_multipart_jpeg_chunk_matches_jax(pair):
    """One MJPEG multipart chunk of four JPEGs and a bad part through both
    servers: decoded frames within one grey level (0 seen; the max is in
    the assertion's message), the bad part a decode error on both, and
    scores within
    1e-5 for windows whose decoded frames are equal."""
    from PIL import Image
    port, ref = pair
    frames = _frames(4, seed=81)
    blobs = [_jpeg(f) for f in frames]
    got = [ingest.decode_frame_bytes(b) for b in blobs]
    want = [j_ingest.decode_frame_bytes(b) for b in blobs]
    grey = max(int(np.abs(g.astype(int) - w.astype(int)).max())
               for g, w in zip(got, want))
    assert grey <= 1, f"decoded frames differ by {grey} grey levels"
    pil = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in
           blobs]
    assert all(np.array_equal(g, p) for g, p in zip(got, pil))
    body = b"".join(b"--f\r\nContent-Type: image/jpeg\r\n\r\n" + b + b"\r\n"
                    for b in blobs + [b"NOT A JPEG"]) + b"--f--\r\n"
    ctype = {"Content-Type": "multipart/x-mixed-replace; boundary=f"}
    for side in (port, ref):
        _req(side.port, "POST", "/streams", b'{"stream_id": "jpg"}')
        st, ack = _req(side.port, "POST", "/streams/jpg/frames", body, ctype)
        assert st == 200 and (ack["frames_accepted"], ack["decode_errors"],
                              ack["windows_emitted"]) == (4, 1, 2)
        side.wait("jpg", 2)
    for w in range(2):
        if all(np.array_equal(got[i], want[i]) for i in (2 * w, 2 * w + 1)):
            _same_scores(port, ref, [("jpg", 0, w)])
    for side in (port, ref):
        _req(side.port, "DELETE", "/streams/jpg")


def _push(side, sid, frames):
    side.manager.get(sid).ingest_arrays(list(frames))


def _continued(side, sid, n):
    s = side.wait(sid, n)
    st = s.status(events=64)
    return st, sorted(k[1:] for k in side.scores if k[0] == sid)


@pytest.mark.parametrize("pair", ["f32"], indirect=True)
def test_snapshots_cross_between_packages(pair, tmp_path):
    """Mid-window sessions (5 frames, hop 2: a frame buffered): the JAX
    export imports into the port and the port's into JAX (the migration
    pair), and the port's ``--state-dir`` snapshot restores in JAX (the
    restart pair); each goes on with 7 more frames exactly as an
    uninterrupted port session does — window indices, verdict events
    (stream ids and timestamps aside) and books equal, scores within 1e-5
    (within the port too: a window's bucket, 1 or 4, follows its arrival
    time, and the CPU's convolutions are not bitwise across batch
    sizes)."""
    port, ref = pair
    head, tail = _frames(5, seed=82), _frames(7, seed=83)
    for side, sid in ((ref, "j2p"), (port, "p2j"), (port, "ref"),
                      (port, "dir")):
        side.manager.create(sid)
        _push(side, sid, head)
        side.wait(sid, 2)
    to_port = json.loads(json.dumps(ref.manager.export_session("j2p")))
    to_jax = json.loads(json.dumps(port.manager.export_session("p2j")))
    port.manager.import_session(to_port)
    ref.manager.import_session(to_jax)
    sdir = tmp_path / "state"
    port.manager.save_state(str(sdir))            # "ref" and "dir" and "j2p"
    for name in ("ref", "j2p"):
        (sdir / f"{name}.state.json").unlink()
    assert ref.manager.restore_state(str(sdir)) == 1
    assert port.manager.close("dir") is not None
    for side, sid in ((port, "j2p"), (ref, "p2j"), (port, "ref"),
                      (ref, "dir")):
        assert side.manager.get(sid).windows_scored == 2
        _push(side, sid, tail)
    want_st, want_w = _continued(port, "ref", 6)
    for side, sid in ((port, "j2p"), (ref, "p2j"), (ref, "dir")):
        st, w = _continued(side, sid, 6)
        assert [k for k in w if k[1] >= 2] == [k for k in want_w
                                               if k[1] >= 2]
        strip = [{k: v for k, v in e.items() if k != "stream_id"}
                 for e in _events(st)]
        assert strip == [{k: v for k, v in e.items() if k != "stream_id"}
                         for e in _events(want_st)]
        assert st["counters"] == want_st["counters"]
        assert st["stream"] == want_st["stream"]
    tail_keys = [k for k in port.scores if k[0] == "ref" and k[2] >= 2]
    for sid, side in (("j2p", port), ("p2j", ref), ("dir", ref)):
        for _, tid, w in tail_keys:
            assert abs(side.scores[(sid, tid, w)]
                       - port.scores[("ref", tid, w)]) <= TOL
    for side, sid in ((port, "j2p"), (ref, "p2j"), (port, "ref"),
                      (ref, "dir")):
        side.manager.close(sid)
