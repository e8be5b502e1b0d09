"""PyTorch port, the serving replica against the JAX package, on the CPU.

The port's ``serving`` engine, HTTP front end and runner against the JAX
package's on the flagship ``efficientnet_deepfake_v4`` reduced as in
``tests/test_torch_efficientnet.py`` (``channel_multiplier=0.25``,
``depth_multiplier=0.34``, 12 channels) at a 64² canvas, buckets (1, 4,
16).  BN statistics are calibrated by one train-mode pass over 32 seeded
clips (running stats := the batch's), so scores are not the 0.5/0.5 of a
fresh init; the weights cross to JAX through
``tools/convert_torch_checkpoint.convert_state_dict``.

On the CPU the port's programs run eagerly (on the card they are captured
CUDA graphs; ``chip_smoke.py``'s serve phase holds those).  Tolerances:
P(fake) port against JAX within 1e-5 (f32 through the reduced flagship,
summed in other orders by XLA and torch); everything inside the port —
padded rows against unpadded, server against the CLI's ``test_img``, the
uint8 wire's device normalize against the host's — bitwise.
"""

import base64
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from deepfake_detection_tpu.config import ServeConfig as JServeConfig
from deepfake_detection_tpu.fleet.controller import HealthScraper
from deepfake_detection_tpu.fleet.metrics import RouterMetrics
from deepfake_detection_tpu.fleet.registry import Registry
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.serving.batcher import \
    MicroBatcher as JMicroBatcher
from deepfake_detection_tpu.serving.engine import \
    InferenceEngine as JInferenceEngine
from deepfake_detection_tpu.serving.http import make_server as j_make_server
from deepfake_detection_tpu.serving.http import \
    serve_forever_in_thread as j_serve_forever
from deepfake_detection_tpu.serving.metrics import \
    ServingMetrics as JServingMetrics
from deepfake_detection_tpu_torch.csrc import build as kernels
from deepfake_detection_tpu_torch.models import (create_deepfake_model_v4,
                                                 create_model)
from deepfake_detection_tpu_torch.params import (normalize_concat,
                                                 normalize_replicate,
                                                 prepare_canvas)
from deepfake_detection_tpu_torch.runners import serve as serve_runner
from deepfake_detection_tpu_torch.runners import test as cli
from deepfake_detection_tpu_torch.serving.batcher import MicroBatcher
from deepfake_detection_tpu_torch.serving.config import ServeConfig
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from deepfake_detection_tpu_torch.serving.http import (make_server,
                                                       serve_forever_in_thread)
from deepfake_detection_tpu_torch.serving.metrics import (ServingMetrics,
                                                          capture_count)
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

pytestmark = pytest.mark.serving

NAME = "efficientnet_deepfake_v4"
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.34)
SIZE = 64
BUCKETS = (1, 4, 16)
TOL = 1e-5
TIMEOUT = 30


def _frame(seed: int, hw=(90, 70)) -> np.ndarray:
    """Smooth content plus noise, uint8 (H, W, 3), not canvas-sized."""
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx[..., None] / (5 + seed % 7)
                              + yy[..., None] / 7 + np.arange(3) * seed)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _canvases(n: int, seed: int = 0):
    return [prepare_canvas(_frame(seed + i, (60 + 7 * i, 90 - 5 * i)), SIZE)
            for i in range(n)]


def _calibrate(model: torch.nn.Module, size: int) -> dict:
    """One train-mode pass over 32 seeded clips (running stats := the
    batch's); returns the state dict."""
    cans = [prepare_canvas(_frame(100 + i), size) for i in range(8)]
    batch = np.stack([normalize_replicate(c, 4) for c in cans])
    rng = np.random.default_rng(1)
    calib = np.concatenate([batch] + [
        batch + 0.3 * rng.standard_normal(batch.shape).astype(np.float32)
        for _ in range(3)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(calib).permute(0, 3, 1, 2))
    model.eval()
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def state():
    return _calibrate(create_model(NAME, bn_momentum=1.0, device="cpu",
                                   **KW), SIZE)


def _port_model(sd):
    model = create_model(NAME, device="cpu", **KW)
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module")
def jax_side(state):
    return j_create_model(NAME, **KW), convert_state_dict(
        {k: v.numpy() for k, v in state.items()})


def _payloads(wire: str, clip: bool, n: int, seed: int = 0):
    out = []
    for i in range(n):
        cans = _canvases(4 if clip else 1, seed + 10 * i)
        if wire == "float32":
            out.append(normalize_concat(cans) if clip
                       else normalize_replicate(cans[0], 4))
        else:
            out.append(np.concatenate(cans, axis=-1) if clip else cans[0])
    return out


@pytest.fixture(scope="module", params=["float32", "uint8"])
def pair(request, state, jax_side):
    """(wire, port engine, JAX engine), neither started."""
    wire = request.param
    port = InferenceEngine(_port_model(state), image_size=SIZE, img_num=4,
                           buckets=BUCKETS, wire=wire)
    jm, jv = jax_side
    ref = JInferenceEngine(jm, jv, image_size=SIZE, img_num=4,
                           buckets=BUCKETS, wire=wire)
    return wire, port, ref


# ---------------------------------------------------------------------------
# engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [False, True], ids=["single", "clip"])
def test_engine_scores_match_jax(pair, clip):
    wire, port, ref = pair
    for n in (1, 3, 5):                       # buckets 1, 4 and 16
        xs = _payloads(wire, clip, n, seed=n)
        got, want = port.score_batch(xs), ref.score_batch(xs)
        assert got.shape == want.shape == (n, 2)
        assert np.abs(want[:, 0] - 0.5).max() > 1e-3, want   # not degenerate
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_padded_rows_bitwise_equal_to_unpadded(pair):
    wire, port, _ = pair
    xs = _payloads(wire, False, 4, seed=40)
    padded = port.score_batch(xs[:3])         # 3 -> bucket 4, one pad row
    full = port.score_batch(xs)               # bucket 4, no pad
    np.testing.assert_array_equal(padded, full[:3])
    other = port.score_batch(xs[:3] + _payloads(wire, False, 1, seed=99))
    np.testing.assert_array_equal(padded, other[:3])   # pad content moot
    assert np.allclose(padded.sum(axis=1), 1.0, atol=1e-6)


def test_zero_new_programs_across_mixed_batch_sizes(pair):
    wire, port, _ = pair
    warm = port.compile_count
    assert warm == len(BUCKETS) * (2 if wire == "uint8" else 1)
    captures = capture_count()
    for n in (1, 2, 3, 4, 5, 11, 16):
        assert port.score_batch(_payloads(wire, False, n, seed=n)).shape \
            == (n, 2)
    with pytest.raises(ValueError):           # beyond the largest bucket
        port.score_batch(_payloads(wire, False, 17))
    with pytest.raises(ValueError, match="channels"):
        port.score_batch([np.zeros((SIZE, SIZE, 6), np.float32)])
    assert port.compile_count == warm
    assert capture_count() == captures == 0   # the CPU captures nothing


def test_uint8_wire_device_normalize_is_the_host_preprocess(state):
    """The uint8 wire's in-program normalize and ×4 replication give the
    float32 wire's scores bitwise (elementwise f32 in both)."""
    model = _port_model(state)
    u8, f32 = (InferenceEngine(model, image_size=SIZE, img_num=4,
                               buckets=(4,), wire=wire)
               for wire in ("uint8", "float32"))
    for clip in (False, True):
        np.testing.assert_array_equal(
            u8.score_batch(_payloads("uint8", clip, 3, seed=7)),
            f32.score_batch(_payloads("float32", clip, 3, seed=7)))


# ---------------------------------------------------------------------------
# HTTP: port server against the JAX server
# ---------------------------------------------------------------------------

def _post(port, path, body, ctype, timeout=TIMEOUT):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path, timeout=TIMEOUT):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.status, r.read().decode()


def _png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _npy(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _serve(engine, metrics, batcher_cls, make, run):
    batcher = batcher_cls(max_batch=BUCKETS[-1], deadline_ms=5.0,
                          max_queue=64, metrics=metrics)
    engine.start(batcher)
    server = make("127.0.0.1", 0, engine, batcher, metrics,
                  request_timeout_s=20.0)
    run(server)
    return type("S", (), dict(engine=engine, batcher=batcher,
                              metrics=metrics, server=server,
                              port=server.server_address[1]))


def _shutdown(s):
    s.server.shutdown()
    s.engine.stop()
    s.batcher.close()
    s.server.server_close()


@pytest.fixture(scope="module")
def servers(state, jax_side):
    pm, jm_ = ServingMetrics(), JServingMetrics()
    port = _serve(InferenceEngine(_port_model(state), image_size=SIZE,
                                  img_num=4, buckets=BUCKETS, metrics=pm),
                  pm, MicroBatcher, make_server, serve_forever_in_thread)
    jm, jv = jax_side
    ref = _serve(JInferenceEngine(jm, jv, image_size=SIZE, img_num=4,
                                  buckets=BUCKETS, metrics=jm_),
                 jm_, JMicroBatcher, j_make_server, j_serve_forever)
    yield port, ref
    _shutdown(port)
    _shutdown(ref)


def _bodies():
    frames = [_frame(200 + i, (70 + 3 * i, 50 + 5 * i)) for i in range(4)]
    pngs = [_png(f) for f in frames]
    clip_json = json.dumps({"frames_b64": [base64.b64encode(p).decode()
                                           for p in pngs]}).encode()
    multipart = b"".join(b"--clip\r\nContent-Type: image/png\r\n\r\n" + p
                         + b"\r\n" for p in pngs) + b"--clip--\r\n"
    return [(pngs[0], "image/png"),
            (json.dumps({"image_b64": base64.b64encode(pngs[1]).decode()}
                        ).encode(), "application/json"),
            (clip_json, "application/json"),
            (multipart, "multipart/form-data; boundary=clip")]


def test_server_matches_jax_server(servers):
    port, ref = servers
    for body, ctype in _bodies():
        s1, got = _post(port.port, "/score", body, ctype)
        s2, want = _post(ref.port, "/score", body, ctype)
        assert s1 == s2 == 200
        assert set(got) == set(want)
        assert set(got["timings_ms"]) == set(want["timings_ms"])
        assert got["frames"] == want["frames"]
        assert got["model"] == want["model"]
        assert abs(got["fake_score"] - want["fake_score"]) <= TOL
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=TOL)
    r1, r2 = (json.loads(_get(s.port, "/readyz")[1]) for s in servers)
    assert set(r1) == set(r2)
    assert set(r1["models"]) == set(r2["models"]) == {"default"}
    assert set(r1["models"]["default"]) == set(r2["models"]["default"])
    assert r1["models"]["default"]["warm_buckets"] == list(BUCKETS)


def _bad_request(case: str):
    """(path, body, content type) of one malformed request."""
    png = _png(_frame(1))
    b64 = base64.b64encode(png).decode()
    return {
        "undecodable": ("/score", b"not an image", "image/png"),
        "bad_base64": ("/score", b'{"frames_b64": ["!!"]}',
                       "application/json"),
        "two_frames": ("/score", json.dumps({"frames_b64": [b64, b64]})
                       .encode(), "application/json"),   # not 1 or img_num
        "unknown_model": ("/score?model=nope", png, "image/png"),
        "empty_body": ("/score", b"", "image/png"),
    }[case]


@pytest.mark.parametrize("case", ["undecodable", "bad_base64", "two_frames",
                                  "unknown_model", "empty_body"])
def test_error_statuses_match_jax(servers, case):
    path, body, ctype = _bad_request(case)
    code = 400
    got = []
    for s in servers:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(s.port, path, body, ctype)
        got.append((ei.value.code, set(json.loads(ei.value.read()))))
    assert got[0] == got[1] and got[0][0] == code
    for s in servers:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(s.port, "/nope")
        assert ei.value.code == 404


def _metric_names(text: str):
    return {re.split(r"[{ ]", ln, 1)[0] for ln in text.splitlines()
            if ln.startswith("dfd_serving_")} | set(
        re.findall(r"^# HELP (dfd_serving_\S+)", text, re.M))


def test_metrics_catalog_names_equal_jax(servers):
    for body, ctype in _bodies()[:2]:
        for s in servers:
            _post(s.port, "/score", body, ctype)
    port, ref = (_metric_names(_get(s.port, "/metrics")[1]) for s in servers)
    assert port == ref
    assert {"dfd_serving_compiles_total", "dfd_serving_backend_compiles_total",
            "dfd_serving_ready", "dfd_serving_breaker_state",
            "dfd_serving_queue_depth"} <= port
    text = _get(servers[0].port, "/metrics")[1]
    assert f"dfd_serving_compiles_total {len(BUCKETS)}" in text
    assert "dfd_serving_backend_compiles_total 0" in text


def test_fleet_scraper_reads_the_port_server(servers):
    port = servers[0]
    reg = Registry([f"127.0.0.1:{port.port}"])
    scraper = HealthScraper(reg, RouterMetrics(), timeout_s=10.0)
    r = reg.all()[0]
    scraper.scrape_once(r)
    assert r.healthy and r.ready and not r.warming
    assert r.breaker_state == 0 and r.queue_depth == 0 and r.inflight == 0
    assert r.readiness["models"]["default"]["warmed"] is True
    port.metrics.ready = False                # a cold model: warming
    try:
        scraper.scrape_once(r)
        assert r.healthy and not r.ready and r.warming
    finally:
        port.metrics.ready = True


def test_npy_frames_without_pillow(servers, monkeypatch):
    """``.npy`` bodies need only numpy; another format without Pillow is a
    400 that says so."""
    port = servers[0]
    frame = _frame(5)
    png = _png(frame)
    _, with_pil = _post(port.port, "/score", png, "image/png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    status, body = _post(port.port, "/score", _npy(frame),
                         "application/octet-stream")
    assert status == 200 and body["fake_score"] == with_pil["fake_score"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port.port, "/score", png, "image/png")
    assert ei.value.code == 400
    err = json.loads(ei.value.read())["error"]
    assert "Pillow" in err and ".npy" in err


# ---------------------------------------------------------------------------
# server against the port's CLI (full-depth flagship), bitwise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("flagship")
    sd = _calibrate(create_deepfake_model_v4(bn_momentum=1.0, device="cpu"),
                    SIZE)
    path = d / "flagship.pth"
    torch.save(sd, path)
    return d, path


def test_server_matches_cli_bitwise(flagship_ckpt):
    d, ckpt = flagship_ckpt
    frames = [_frame(300 + i, (90 - 9 * i, 60 + 11 * i)) for i in range(4)]
    npys, pngs = [], []
    for i, f in enumerate(frames):
        npys.append(d / f"f{i}.npy")
        np.save(npys[-1], f)
        pngs.append(d / f"f{i}.png")
        Image.fromarray(f).save(pngs[-1])
    cfg = ServeConfig(device="cpu", port=0, image_size=SIZE,
                      buckets=(1, 4), max_queue=8, model_path=str(ckpt),
                      watchdog_timeout_s=0.0, request_timeout_ms=20000.0)
    s = serve_runner.build_server(cfg)
    s.engine.start(s.batcher)
    serve_forever_in_thread(s)
    port = s.server_address[1]
    try:
        want = cli.test_img(str(ckpt), [str(p) for p in npys], size=SIZE,
                            device="cpu")
        assert np.abs(np.asarray(want) - 0.5).max() > 1e-3, want
        for i, (npy, png) in enumerate(zip(npys, pngs)):
            _, a = _post(port, "/score", npy.read_bytes(),
                         "application/octet-stream")
            _, b = _post(port, "/score", png.read_bytes(), "image/png")
            assert a["fake_score"] == b["fake_score"] == want[i]
        clip = cli.test_img(str(ckpt), [str(p) for p in npys], size=SIZE,
                            clip=True, device="cpu")
        body = json.dumps({"frames_b64": [
            base64.b64encode(p.read_bytes()).decode() for p in npys]})
        _, c = _post(port, "/score", body.encode(), "application/json")
        assert c["frames"] == 4 and c["fake_score"] == clip[0]
        # the uint8 wire (normalize in the program) gives the same bits
        u8 = InferenceEngine(s.engine.model, image_size=SIZE, img_num=4,
                             buckets=(1,), wire="uint8")
        got = u8.score_batch([prepare_canvas(frames[0], SIZE)])
        assert float(got[0, 0]) == want[0]
    finally:
        s.shutdown()
        s.engine.stop()
        s.batcher.close()
        s.server_close()


# ---------------------------------------------------------------------------
# the runner: flags, multi-model table, cascade
# ---------------------------------------------------------------------------

def test_every_jax_serve_flag_is_a_port_flag_with_its_default():
    port = {f.name: f.default for f in fields(ServeConfig)}
    for f in fields(JServeConfig):
        assert f.name in port, f.name
        assert port[f.name] == f.default, f.name
    parser = ServeConfig.argument_parser()
    flags = {a for act in parser._actions for a in act.option_strings}
    assert {"--" + f.name.replace("_", "-")
            for f in fields(JServeConfig)} <= flags
    assert port["device"] == "cuda"
    cfg = ServeConfig.from_args(["--buckets", "16,1,4,4", "--device", "cpu",
                                 "--wire", "uint8", "--use-ema"])
    assert cfg.buckets == (1, 4, 16) and cfg.max_batch_size == 16
    assert cfg.in_chans == 12 and cfg.wire == "uint8" and cfg.use_ema
    with pytest.raises(ValueError):
        ServeConfig(buckets=(0, 4))


@pytest.mark.parametrize("argv,item", [
    (["--warmstart-dir", "ws"], "item 10"),
    (["--compile-cache-dir", "cc"], "item 10"),
    (["--single-thread-xla"], "item 10"),
    (["--warm-parallel", "2"], "one at a time"),
])
def test_unported_flags_raise_naming_their_roadmap_item(argv, item,
                                                        tmp_path):
    if argv[0] == "--warmstart-dir":
        # item 10 is ported: the flag is accepted and attaches the store;
        # the second engine's capture hits the first one's manifest
        store = str(tmp_path / argv[1])
        cfg = ServeConfig.from_args(
            ["--warmstart-dir", store, "--device", "cpu", "--model",
             "efficientnet_b0", "--image-size", "32", "--img-num", "1",
             "--buckets", "1"])
        books = []
        try:
            for _ in range(2):
                engine, _, metrics = serve_runner.build_engine(cfg)
                assert engine.warmstart.root == store
                books.append((metrics.warmstart_hits_total.value,
                              metrics.warmstart_misses_total.value,
                              metrics.warmstart_serialized_total.value))
        finally:
            kernels.set_store(None)
        assert books == [(0, 1, 1), (1, 0, 0)]
        return
    with pytest.raises(NotImplementedError, match=item):
        ServeConfig.from_args(argv)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: --device cuda serves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_runner.build_engine(ServeConfig(image_size=SIZE,
                                              buckets=(1,), max_queue=4))


def test_runner_multi_model_table_and_cascade_books(flagship_ckpt):
    """--models adds a student at a 32² canvas, --cascade routes unrouted
    requests student-first; the cascade books balance and a routed request
    reaches the flagship."""
    _, ckpt = flagship_ckpt
    cfg = ServeConfig.from_args([
        "--device", "cpu", "--port", "0", "--image-size", str(SIZE),
        "--buckets", "1,4", "--max-queue", "8", "--model-path", str(ckpt),
        "--models", f"student={NAME},size=32", "--cascade", "student",
        "--cascade-low", "0.0", "--cascade-high", "1.0",
        "--watchdog-timeout-s", "0", "--request-timeout-ms", "20000"])
    s = serve_runner.build_server(cfg)
    s.engine.start(s.batcher)
    serve_forever_in_thread(s)
    port = s.server_address[1]
    try:
        assert s.engine.model_ids() == (NAME, "student")
        assert s.engine.compile_count == 4      # 2 models x 2 buckets
        body = _npy(_frame(9))
        for _ in range(3):
            status, out = _post(port, "/score", body,
                                "application/octet-stream")
            assert status == 200 and out["cascade"]["escalated"]
            assert out["model"] == NAME
        _, routed = _post(port, "/score?model=student", body,
                          "application/octet-stream")
        assert routed["model"] == "student" and "cascade" not in routed
        m = s.engine.metrics
        assert m.cascade_triaged_total.value == 3
        assert m.cascade_triaged_total.value == \
            m.cascade_cleared_total.value + m.cascade_escalated_total.value
        assert m.cascade_escalated_total.value == \
            m.cascade_flagship_scored_total.value \
            + m.cascade_escalation_failed_total.value
        ready = json.loads(_get(port, "/readyz")[1])
        assert ready["models"]["student"]["image_size"] == 32
    finally:
        s.shutdown()
        s.engine.stop()
        s.batcher.close()
        s.server_close()


def test_verdict_cache_hits_and_a_reload_orphans_it(flagship_ckpt):
    """--cache-entries: a repeated clip is a cache hit with the same score;
    a hot reload changes the weight fingerprint, so the next copy misses
    and is scored by the new weights."""
    _, ckpt = flagship_ckpt
    cfg = ServeConfig(device="cpu", port=0, image_size=32, buckets=(1,),
                      max_queue=4, model_path=str(ckpt), cache_entries=8,
                      watchdog_timeout_s=0.0, request_timeout_ms=20000.0)
    s = serve_runner.build_server(cfg)
    s.engine.start(s.batcher)
    serve_forever_in_thread(s)
    port = s.server_address[1]
    m = s.engine.metrics
    try:
        body = _npy(_frame(21))
        _, first = _post(port, "/score", body, "application/octet-stream")
        _, again = _post(port, "/score", body, "application/octet-stream")
        assert again["fake_score"] == first["fake_score"]
        assert m.cache_hit_total.value == 1 and m.scored_total.value == 1
        fp = s.engine.model_fingerprint()
        new = {k: v * 1.01 if v.is_floating_point() and "running" not in k
               else v for k, v in torch.load(ckpt, weights_only=True).items()}
        s.engine.submit_reload(new, source="<test>")
        deadline = time.monotonic() + TIMEOUT
        while s.engine.reload_count == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s.engine.reload_count == 1
        assert s.engine.model_fingerprint() != fp
        _, after = _post(port, "/score", body, "application/octet-stream")
        assert m.cache_hit_total.value == 1 and m.scored_total.value == 2
        assert after["fake_score"] != first["fake_score"]
        assert m.accepted_total.value == 3
    finally:
        s.shutdown()
        s.engine.stop()
        s.batcher.close()
        s.server_close()


def test_runner_main_serves_and_stops_on_sigterm(tmp_path):
    """``python -m ...runners.serve`` in a fresh interpreter: ready, one
    ``.npy`` scored, SIGTERM exits 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfake_detection_tpu_torch.runners.serve",
         "--device", "cpu", "--image-size", "32", "--buckets", "1",
         "--max-queue", "4", "--port", str(port), "--watchdog-timeout-s",
         "0", "--request-timeout-ms", "60000"], cwd=tmp_path, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            try:
                if _get(port, "/readyz", timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stderr.read().decode()
                time.sleep(0.2)
        status, out = _post(port, "/score", _npy(_frame(3)),
                            "application/octet-stream")
        assert status == 200 and out["frames"] == 1
        assert out["model"] == NAME and 0.0 <= out["fake_score"] <= 1.0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


# ---------------------------------------------------------------------------
# on the card: the captured graphs against the CPU's eager programs
# ---------------------------------------------------------------------------

@pytest.mark.card
def test_graphs_on_the_card_match_the_cpu(state):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the depthwise "
                    "kernel have no CPU mode)")
    cpu = InferenceEngine(_port_model(state), image_size=SIZE, img_num=4,
                          buckets=BUCKETS)
    card = InferenceEngine(_port_model(state).to(
        "cuda", memory_format=torch.channels_last), image_size=SIZE,
        img_num=4, buckets=BUCKETS)
    captures = capture_count()
    for n in (1, 3, 5):
        xs = _payloads("float32", False, n, seed=n)
        np.testing.assert_allclose(card.score_batch(xs), cpu.score_batch(xs),
                                   rtol=0, atol=TOL)
    assert capture_count() == captures
    assert card.launch_counts()["depthwise_fwd"] > 0
