"""PyTorch port, serving resilience on the CPU: the JAX package's contracts
(``tests/test_serving_resilience.py``) held on the port's engine.

Circuit breaker, jittered Retry-After, non-finite batches, the stuck-batch
watchdog (hang and worker kill, re-warm without a new program), the reload
canary (NaN weights, a shape mismatch, a torn torch file, the drift gate;
a rejected reload leaves the scores bitwise unchanged), ``/readyz`` during
the canary, the HTTP mapping of each fault, the request books under mixed
load, and a hot reload of a checkpoint that the port's own train runner
wrote.  Every fault is injected in-process through the engine's ``chaos``
argument.  The model is the reduced flagship of
``tests/test_torch_serving.py`` (12 channels, 64²), BN calibrated by one
train-mode pass; its programs run eagerly on the CPU.
"""

import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deepfake_detection_tpu_torch.chaos import ChaosInjector
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.models.helpers import load_checkpoint
from deepfake_detection_tpu_torch.params import (normalize_replicate,
                                                 prepare_canvas)
from deepfake_detection_tpu_torch.runners import train as train_runner
from deepfake_detection_tpu_torch.serving.batcher import (MicroBatcher,
                                                          QueueFull)
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from deepfake_detection_tpu_torch.serving.http import (make_server,
                                                       serve_forever_in_thread)
from deepfake_detection_tpu_torch.serving.metrics import (ServingMetrics,
                                                          capture_count)
from deepfake_detection_tpu_torch.serving.resilience import (
    BreakerOpen, CircuitBreaker, EngineStalled, NonFiniteScores,
    jittered_retry_after)

torch.set_num_threads(2)

pytestmark = pytest.mark.serving

NAME = "efficientnet_deepfake_v4"
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.34)
SIZE = 64
TIMEOUT = 20


def _payload(seed=0):
    rng = np.random.default_rng(seed)
    return normalize_replicate(prepare_canvas(
        rng.integers(0, 255, (48, 40, 3), dtype=np.uint8), SIZE), 4)


def _npy_body(seed=0):
    import io
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(
        0, 255, (40, 40, 3), dtype=np.uint8))
    return buf.getvalue()


@pytest.fixture(scope="module")
def calibrated():
    model = create_model(NAME, bn_momentum=1.0, device="cpu", **KW)
    x = np.stack([_payload(i) for i in range(32)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _perturbed(state, seed):
    """The calibrated weights with every float parameter nudged."""
    rng = np.random.default_rng(seed)
    return {k: (v + torch.from_numpy(0.02 * rng.standard_normal(
        tuple(v.shape)).astype(np.float32))
        if v.is_floating_point() and "running" not in k else v.clone())
        for k, v in state.items()}


def _model(state):
    model = create_model(NAME, device="cpu", **KW)
    model.load_state_dict(state)
    return model.eval()


def _engine(state, *, chaos="", buckets=(1,), watchdog_timeout_s=0.0, **kw):
    return InferenceEngine(
        _model(state), image_size=SIZE, img_num=4, buckets=buckets,
        metrics=ServingMetrics(), chaos=ChaosInjector(chaos),
        watchdog_timeout_s=watchdog_timeout_s, **kw)


def _started(eng, max_batch=1):
    b = MicroBatcher(max_batch=max_batch, deadline_ms=1.0, max_queue=8,
                     metrics=eng.metrics)
    eng.start(b)
    return b


def _books(m: ServingMetrics):
    return (m.accepted_total.value,
            m.scored_total.value + m.shed_total.value +
            m.deadline_total.value + m.failed_total.value)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------------------
# circuit breaker state machine (injected clock)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_opens_on_consecutive_failures_only():
    clk = _Clock()
    b = CircuitBreaker(failure_threshold=3, open_s=5.0, clock=clk)
    for _ in range(10):
        b.record_failure()
        b.record_failure()
        b.record_success()
        b.allow()
    assert b.state == "closed"
    for _ in range(3):
        b.record_failure()
    assert b.state == "open"
    with pytest.raises(BreakerOpen) as ei:
        b.allow()
    assert 0 < ei.value.retry_after_s <= 5.0 + b.retry_jitter_s


def test_breaker_half_open_single_probe_then_close_or_reopen():
    clk = _Clock()
    b = CircuitBreaker(failure_threshold=1, open_s=5.0, clock=clk)
    b.record_failure()
    clk.t += 5.1
    b.allow()                      # the probe is admitted
    assert b.state == "half_open"
    with pytest.raises(BreakerOpen):
        b.allow()                  # ...but only ONE probe
    b.record_success()
    assert b.state == "closed"
    b.record_failure()
    clk.t += 5.1
    b.allow()
    b.record_failure()             # probe failed
    assert b.state == "open"
    with pytest.raises(BreakerOpen):
        b.allow()


def test_breaker_unreported_probe_and_threshold_zero():
    clk = _Clock()
    b = CircuitBreaker(failure_threshold=1, open_s=2.0, clock=clk)
    b.record_failure()
    clk.t += 2.1
    b.allow()                      # probe admitted, outcome never reported
    clk.t += 2.1
    b.allow()                      # the next arrival re-probes
    off = CircuitBreaker(failure_threshold=0, open_s=1.0)
    for _ in range(100):
        off.record_failure()
    assert off.state == "closed"
    off.allow()


def test_retry_after_is_jittered():
    import random
    rng = random.Random(3)
    vals = [jittered_retry_after(1.0, 2.0, rng) for _ in range(200)]
    assert all(1.0 <= v < 3.0 for v in vals)
    assert len({round(v, 3) for v in vals}) > 100
    m = ServingMetrics()
    b = MicroBatcher(max_batch=4, deadline_ms=1.0, max_queue=1, metrics=m,
                     retry_jitter_s=2.0)
    b.submit(np.zeros((4, 4, 3), np.uint8))
    retries = []
    for _ in range(24):
        with pytest.raises(QueueFull) as ei:
            b.submit(np.zeros((4, 4, 3), np.uint8))
        retries.append(ei.value.retry_after_s)
    assert all(1.0 <= r < 3.0 for r in retries)
    assert len({round(r, 3) for r in retries}) >= 2
    assert m.accepted_total.value == 25 and m.shed_total.value == 24
    b.close()


# ---------------------------------------------------------------------------
# engine faults: non-finite, exception, hang, kill, breaker
# ---------------------------------------------------------------------------

def test_nonfinite_batch_fails_requests_and_next_batch_serves(calibrated):
    eng = _engine(calibrated, chaos="serve_nan@0")
    b = _started(eng)
    try:
        with pytest.raises(NonFiniteScores):
            b.submit(_payload(), timeout_s=10).result(timeout=TIMEOUT)
        assert eng.metrics.nonfinite_batches_total.value == 1
        scores = b.submit(_payload(1), timeout_s=10).result(timeout=TIMEOUT)
        assert scores.shape == (2,) and np.isfinite(scores).all()
        assert _books(eng.metrics) == (2, 2)
    finally:
        eng.stop()
        b.close()


def test_injected_score_fn_exception_recovers(calibrated):
    eng = _engine(calibrated, chaos="serve_exc@0")
    b = _started(eng)
    try:
        with pytest.raises(RuntimeError, match="chaos"):
            b.submit(_payload(), timeout_s=10).result(timeout=TIMEOUT)
        assert _wait(lambda: eng.metrics.worker_restarts_total.value == 1)
        assert b.submit(_payload(1), timeout_s=10).result(
            timeout=TIMEOUT).shape == (2,)
        assert _books(eng.metrics) == (2, 2)
    finally:
        eng.stop()
        b.close()


def test_hang_watchdog_fails_inflight_rewarms_without_new_programs(
        calibrated):
    eng = _engine(calibrated, chaos="serve_hang@0:8", buckets=(1, 4),
                  watchdog_timeout_s=0.5)
    eng.watchdog.poll_s = 0.02
    ready_during_rewarm = []
    orig_rewarm = eng._rewarm

    def spying_rewarm():
        ready_during_rewarm.append(eng.metrics.ready)
        orig_rewarm()

    eng._rewarm = spying_rewarm
    programs, captures = eng.compile_count, capture_count()
    runs = {k: p.replays for k, p in eng.entry().compiled.items()}
    b = _started(eng)
    try:
        with pytest.raises(EngineStalled):
            b.submit(_payload(), timeout_s=30).result(timeout=TIMEOUT)
        assert eng.metrics.watchdog_recoveries_total.value == 1
        assert _wait(lambda: eng.metrics.ready)
        assert ready_during_rewarm == [False]
        assert eng.metrics.rewarms_total.value == 1
        # every program ran again, none was made
        after = {k: p.replays for k, p in eng.entry().compiled.items()}
        assert all(after[k] > runs[k] for k in runs)
        assert b.submit(_payload(1), timeout_s=10).result(
            timeout=TIMEOUT).shape == (2,)
        assert eng.compile_count == programs
        assert capture_count() == captures
        assert _books(eng.metrics) == (2, 2)
    finally:
        eng.stop()
        b.close()


def test_worker_kill_respawned_by_watchdog(calibrated):
    eng = _engine(calibrated, chaos="serve_kill@0", watchdog_timeout_s=5.0)
    eng.watchdog.poll_s = 0.02
    b = _started(eng)
    try:
        assert _wait(
            lambda: eng.metrics.watchdog_recoveries_total.value == 1)
        assert b.submit(_payload(), timeout_s=10).result(
            timeout=TIMEOUT).shape == (2,)
    finally:
        eng.stop()
        b.close()


def test_breaker_opens_after_consecutive_batch_failures(calibrated):
    eng = _engine(calibrated, chaos="serve_exc@0x2", breaker_threshold=2,
                  breaker_open_s=0.3)
    b = _started(eng)
    try:
        for seed in (0, 1):
            with pytest.raises(RuntimeError):
                b.submit(_payload(seed), timeout_s=10).result(
                    timeout=TIMEOUT)
        assert eng.breaker.state == "open"
        assert eng.metrics.breaker_opens_total.value == 1
        with pytest.raises(BreakerOpen):
            eng.breaker.allow()
        time.sleep(0.35)           # cooldown -> half-open probe
        eng.breaker.allow()
        assert b.submit(_payload(2), timeout_s=10).result(
            timeout=TIMEOUT).shape == (2,)
        assert eng.breaker.state == "closed"
    finally:
        eng.stop()
        b.close()


# ---------------------------------------------------------------------------
# hot-reload canary gate + rollback
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reload_stack(calibrated):
    """Engine + HTTP server with NO worker thread: the canary tests drive
    ``_maybe_apply_reload`` synchronously; /healthz, /readyz and /metrics
    still serve."""
    metrics = ServingMetrics()
    engine = InferenceEngine(_model(calibrated), image_size=SIZE, img_num=4,
                             buckets=(1,), metrics=metrics,
                             watchdog_timeout_s=0.0)
    batcher = MicroBatcher(max_batch=1, deadline_ms=1.0, max_queue=16,
                           metrics=metrics)
    server = make_server("127.0.0.1", 0, engine, batcher, metrics,
                         request_timeout_s=10.0)
    serve_forever_in_thread(server)
    yield type("S", (), dict(state=calibrated, engine=engine,
                             metrics=metrics, port=server.server_address[1]))
    server.shutdown()
    engine.stop()
    batcher.close()
    server.server_close()


def _nan_state(state):
    return {k: torch.full_like(v, float("nan")) if v.is_floating_point()
            else v for k, v in state.items()}


@pytest.mark.parametrize("bad", ["nan", "shape", "other_model"])
def test_rejected_reload_leaves_scores_bitwise(reload_stack, bad):
    s = reload_stack
    payload = _payload(5)
    before = s.engine.score_batch([payload])
    fp = s.engine.model_fingerprint()
    errors0 = s.metrics.reload_errors_total.value
    canary0 = s.metrics.reload_canary_failures_total.value
    tree = {"nan": lambda: _nan_state(s.state),
            "shape": lambda: {"nope": np.zeros((3, 3), np.float32)},
            "other_model": lambda: create_model(
                "efficientnet_b0", num_classes=2, device="cpu").state_dict(),
            }[bad]()
    s.engine.submit_reload(tree, source=f"<{bad}>")
    s.engine._maybe_apply_reload()
    assert s.metrics.reload_errors_total.value == errors0 + 1
    assert s.metrics.reload_canary_failures_total.value == \
        canary0 + (bad == "nan")
    assert s.engine.reload_count == 0
    assert s.engine.model_fingerprint() == fp
    np.testing.assert_array_equal(s.engine.score_batch([payload]), before)


def test_watcher_rejects_torn_torch_file_bitwise_rollback(reload_stack,
                                                          tmp_path):
    s = reload_stack
    payload = _payload(7)
    before = s.engine.score_batch([payload])
    errors0 = s.metrics.reload_errors_total.value
    watch_dir = tmp_path / "watch"
    watch_dir.mkdir()
    staging = tmp_path / "next.pth"
    torch.save(_perturbed(s.state, 9), staging)
    data = staging.read_bytes()
    staging.write_bytes(data[:len(data) // 2])       # tear it in half
    s.engine.start_reload_watcher(str(watch_dir), interval_s=0.05)
    os.replace(staging, watch_dir / "next.pth")
    try:
        assert _wait(lambda: s.metrics.reload_errors_total.value
                     == errors0 + 1)
        assert s.engine.reload_count == 0
        np.testing.assert_array_equal(s.engine.score_batch([payload]),
                                      before)
    finally:
        watcher = s.engine.entry().watcher
        s.engine._stop.set()       # stop only the watcher thread
        watcher.join(timeout=5)
        assert not watcher.is_alive()
        s.engine.entry().watcher = None
        s.engine._stop.clear()


def test_canary_drift_tolerance_gates_and_admits(reload_stack):
    s = reload_stack
    payload = _payload(8)
    before = s.engine.score_batch([payload])
    nudged = _perturbed(s.state, 4)
    canary0 = s.metrics.reload_canary_failures_total.value
    try:
        s.engine.reload_drift_tol = 0.0      # zero tolerance: any change
        s.engine.submit_reload(nudged, source="<drift>")
        s.engine._maybe_apply_reload()
        assert s.metrics.reload_canary_failures_total.value == canary0 + 1
        assert s.engine.reload_count == 0
        np.testing.assert_array_equal(s.engine.score_batch([payload]),
                                      before)
        s.engine.reload_drift_tol = 1.0      # softmax drift is <= 1
        s.engine.submit_reload(nudged, source="<drift-2>")
        s.engine._maybe_apply_reload()
        assert s.engine.reload_count == 1
        after = s.engine.score_batch([payload])
        assert not np.array_equal(after, before)
        # the live module now holds the candidate's tensors exactly
        with torch.no_grad():
            want = torch.softmax(_model(nudged)(torch.from_numpy(
                payload[None]).permute(0, 3, 1, 2)), -1).numpy()
        np.testing.assert_array_equal(after, want)
    finally:
        s.engine.reload_drift_tol = -1.0
        s.engine.submit_reload(s.state, source="<restore>")
        s.engine._maybe_apply_reload()
    np.testing.assert_array_equal(s.engine.score_batch([payload]), before)


def test_readyz_drops_during_canary_healthz_stays(reload_stack):
    s = reload_stack
    seen = {}

    def hook():
        seen["ready_flag"] = s.engine.ready
        for path in ("/healthz", "/readyz"):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{s.port}{path}", timeout=5) as r:
                    seen[path] = r.status
            except urllib.error.HTTPError as e:
                seen[path] = e.code

    s.engine._canary_hook = hook
    try:
        s.engine.submit_reload(s.state, source="<ready>")
        s.engine._maybe_apply_reload()
    finally:
        s.engine._canary_hook = None
    assert seen == {"ready_flag": False, "/healthz": 200, "/readyz": 503}
    assert s.engine.ready


# ---------------------------------------------------------------------------
# hot reload of a checkpoint the port's train runner wrote
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model",
              "efficientnet_b0", "--model-version", "", "--input-size-v2",
              "3,32,32", "-b", "2", "--epochs", "1", "--opt", "rmsproptf",
              "--lr", "1e-3", "--model-ema", "--log-interval", "4",
              "--seed", "3", "--compute-dtype", "float32"]


@pytest.mark.parametrize("use_ema,chaos", [(False, ""),
                                           (True, "torn_reload@0")],
                         ids=["model", "ema_after_torn_copy"])
def test_hot_reload_of_a_train_runner_checkpoint(tmp_path, use_ema, chaos):
    """One epoch of ``runners.train`` writes ``last.pth.tar``
    (train/checkpoint.py); copied into the watched dir it is picked up
    between batches, and the engine then scores as an eager forward of the
    same file (the EMA stream with ``use_ema``).  With ``torn_reload`` the
    watcher's first attempt reads a torn copy, is rejected, and the next
    tick loads the real file."""
    watch = tmp_path / "watch"
    watch.mkdir()
    engine = InferenceEngine(
        create_model("efficientnet_b0", num_classes=2, device="cpu"),
        image_size=32, img_num=1, buckets=(1,), watchdog_timeout_s=0.0,
        chaos=ChaosInjector(chaos))
    b = _started(engine)
    try:
        payload = normalize_replicate(prepare_canvas(
            np.random.default_rng(5).integers(0, 255, (40, 30, 3),
                                              dtype=np.uint8), 32), 1)
        before = engine.score_batch([payload])
        engine.start_reload_watcher(str(watch), interval_s=0.05,
                                    use_ema=use_ema)
        out = train_runner.launch_main(TRAIN_ARGS + ["--output",
                                                     str(tmp_path / "run")])
        ckpt = os.path.join(out["output_dir"], "last.pth.tar")
        os.replace(ckpt, watch / "last.pth.tar")
        deadline = time.monotonic() + TIMEOUT
        while engine.reload_count == 0 and time.monotonic() < deadline:
            b.submit(payload, timeout_s=5).result(timeout=TIMEOUT)
        assert engine.reload_count == 1
        assert engine.metrics.reload_errors_total.value == (1 if chaos
                                                            else 0)
        after = engine.score_batch([payload])
        assert not np.array_equal(before, after)
        model = load_checkpoint(create_model("efficientnet_b0",
                                             num_classes=2, device="cpu"),
                                str(watch / "last.pth.tar"),
                                use_ema=use_ema).eval()
        with torch.no_grad():
            want = torch.softmax(model(torch.from_numpy(
                payload[None]).permute(0, 3, 1, 2)), -1).numpy()
        np.testing.assert_array_equal(after, want)
    finally:
        engine.stop()
        b.close()


# ---------------------------------------------------------------------------
# HTTP mapping: non-finite -> 503 + Retry-After, breaker -> 503; books
# ---------------------------------------------------------------------------

def _post(port, body, timeout=TIMEOUT):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/score", data=body,
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers)


@pytest.fixture(scope="module")
def live_stack(calibrated):
    """Engine + RUNNING worker + HTTP server."""
    metrics = ServingMetrics()
    engine = InferenceEngine(_model(calibrated), image_size=SIZE, img_num=4,
                             buckets=(1, 4), metrics=metrics,
                             watchdog_timeout_s=0.0)
    batcher = MicroBatcher(max_batch=4, deadline_ms=2.0, max_queue=64,
                           metrics=metrics)
    engine.start(batcher)
    server = make_server("127.0.0.1", 0, engine, batcher, metrics,
                         request_timeout_s=10.0)
    serve_forever_in_thread(server)
    yield type("S", (), dict(engine=engine, batcher=batcher,
                             metrics=metrics, port=server.server_address[1]))
    server.shutdown()
    engine.stop()
    batcher.close()
    server.server_close()


def test_http_nonfinite_maps_503_with_retry_after(calibrated):
    eng = _engine(calibrated, chaos="serve_nan@0")
    b = _started(eng)
    server = make_server("127.0.0.1", 0, eng, b, eng.metrics,
                         request_timeout_s=10.0)
    serve_forever_in_thread(server)
    port = server.server_address[1]
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, _npy_body())
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert _post(port, _npy_body(1))[0] == 200   # self-healed
    finally:
        server.shutdown()
        eng.stop()
        b.close()
        server.server_close()


def test_http_breaker_open_sheds_503(live_stack):
    s = live_stack
    for _ in range(s.engine.breaker.failure_threshold):
        s.engine.breaker.record_failure()
    try:
        assert s.engine.breaker.state == "open"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(s.port, _npy_body(2))
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert s.metrics.breaker_rejected_total.value >= 1
    finally:
        s.engine.breaker.record_success()
    assert _post(s.port, _npy_body(3))[0] == 200


def test_books_balance_under_mixed_load(live_stack):
    """accepted == scored + shed + deadline + failed, exactly, across
    successes, a poisoned request and concurrent HTTP clients riding
    coalesced, padded batches."""
    s = live_stack
    m = s.metrics
    reqs = [s.batcher.submit(_payload(i), timeout_s=10) for i in range(3)]
    for r in reqs:
        assert r.result(timeout=TIMEOUT).shape == (2,)
    bad = s.batcher.submit(np.zeros((7, 9, 12), np.float32), timeout_s=10)
    with pytest.raises(Exception):
        bad.result(timeout=TIMEOUT)
    statuses = []

    def client(seed):
        for i in range(3):
            try:
                statuses.append(_post(s.port, _npy_body(seed * 10 + i))[0])
            except urllib.error.HTTPError as e:
                statuses.append(e.code)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert statuses.count(200) == 18
    assert s.batcher.submit(_payload(9), timeout_s=10).result(
        timeout=TIMEOUT).shape == (2,)
    assert _wait(lambda: _books(m)[0] == _books(m)[1])
    assert m.batches_total.value < m.scored_total.value   # coalesced
