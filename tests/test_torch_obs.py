"""The port's training observability (``obs/telemetry.py``, ``obs/server.py``,
``obs/profiler.py``, the trainer's and runner's wiring), on the CPU.

* The telemetry registry fed the same host floats as the JAX one renders
  the same Prometheus text and writes the same event records, timestamps
  aside; the catalog, the breakdown and the MFU arithmetic hold.
* The forward FLOP count by ``tools/flops_breakdown.py``'s buckets equals
  that tool's jaxpr walk of the JAX model, bucket by bucket.
* ``peak_flops`` by card name; the watchdog's near-miss counter and beat
  age; the flags.
* A live CPU train run: ``--metrics-port`` answers while it trains, a
  ``PROFILE`` file gives one bounded trace, the unedited
  ``tools/obs_report.py`` renders the run directory; the profiler is inert
  when idle and its signal handler takes no lock (a fresh interpreter
  whose logging and profiler locks another thread holds); the train loop
  reads the same device tensors back, per drain, with telemetry on and
  off, and hands the tracker host floats only.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import models as jmodels
from deepfake_detection_tpu.obs import EventLog as JEventLog
from deepfake_detection_tpu.obs import TrainTelemetry as JTrainTelemetry
from deepfake_detection_tpu_torch.losses import cross_entropy
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.obs import (EventLog, ProfilerCapture,
                                              TrainTelemetry, flops_buckets,
                                              loader_collector,
                                              peak_flops, read_records,
                                              resilience_collector,
                                              start_metrics_server)
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.resilience import StallWatchdog
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from deepfake_detection_tpu_torch.train.trainer import train_one_epoch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120

RUN_ARGS = ["--dataset", "synthetic", "--model", "efficientnet_b0",
            "--model-version", "", "--input-size-v2", "3,32,32", "-b", "2",
            "--epochs", "1", "--device", "cpu", "--log-interval", "1",
            "--workers", "1", "--compute-dtype", "float32"]


def _feed(t, steps=((8, 0.01, 0.05), (8, 0.02, 0.04), (8, 0.0, 0.06))):
    for n, wait, wall in steps:
        t.on_step(n, wait, wall)
    t.on_drain(epoch=1, batch_idx=2, num_updates=3, loss=0.5, prec1=75.0,
               lr=1e-3, drain_wait_s=0.02, nonfinite_steps=1)
    t.inc("recovery_snapshots_total")
    t.event("rewind", reason="3 consecutive bad steps", restored_from="r")
    t.on_step(4, 0.001, 0.01)
    t.on_drain(epoch=1, batch_idx=3, num_updates=4, loss=0.25, prec1=80.0,
               lr=1e-4, drain_wait_s=0.001)
    t.event("epoch_end", epoch=1, train={"loss": 0.25})


def test_registry_renders_and_logs_as_the_jax_one(tmp_path, monkeypatch):
    monkeypatch.setenv("DFD_RESTART_COUNT", "2")
    out = []
    for name, make, log in (("jax", JTrainTelemetry, JEventLog),
                            ("port", TrainTelemetry, EventLog)):
        path = tmp_path / f"{name}.jsonl"
        t = make(event_log=log(str(path)), flops_per_sample=2.5e9,
                 peak_flops=989.4e12)
        t.register_collector(lambda: {"counters": {"input_train_x_total": 3},
                                      "gauges": {"input_train_occ": 0.5}})
        _feed(t)
        text = t.render_prometheus()
        t.close()
        recs = [{k: v for k, v in r.items() if k != "t"}
                for r in read_records(str(path))]
        out.append((text, recs))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1] and len(out[0][1]) == 4


def test_breakdown_and_mfu_arithmetic():
    t = TrainTelemetry(flops_per_sample=1e9, peak_flops=1e12)
    for _ in range(4):
        t.on_step(8, data_wait_s=0.01, step_wall_s=0.05)
    t.on_drain(epoch=1, batch_idx=3, num_updates=4, loss=0.5, prec1=75.0,
               lr=1e-3, drain_wait_s=0.02, nonfinite_steps=1)
    c, g = t.snapshot()["counters"], t.snapshot()["gauges"]
    assert (c["steps_total"], c["samples_total"],
            c["nonfinite_steps_total"]) == (4, 32, 1)
    assert g["data_wait_frac"] + g["device_wait_frac"] + g["host_frac"] == \
        pytest.approx(1.0, abs=2e-4)
    assert g["mfu"] == pytest.approx(g["throughput_imgs_per_s"] * 3e9 / 1e12,
                                     rel=1e-3)


@pytest.mark.parametrize("name,kw,shape", [
    ("efficientnet_deepfake_v4", dict(num_classes=2, in_chans=12,
                                      channel_multiplier=0.25,
                                      depth_multiplier=0.34), (64, 12)),
    ("vit_tiny_patch16_224", dict(num_classes=2, in_chans=3), (32, 3)),
])
def test_flop_buckets_equal_the_jax_tools_walk(name, kw, shape):
    import jax
    spec = importlib.util.spec_from_file_location(
        "_flops_breakdown", REPO / "tools" / "flops_breakdown.py")
    fb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fb)
    size, c = shape
    jm = jmodels.create_model(name, **kw)
    variables = jmodels.init_model(jm, jax.random.PRNGKey(0),
                                   (1, size, size, c))
    want, _, _ = fb.analyze(jm, variables, jnp.zeros((1, size, size, c)),
                            in_chans=c)
    extra = {"img_size": size} if name.startswith("vit") else {}
    got = flops_buckets(create_model(name, device="cpu", **kw, **extra),
                        (2, c, size, size))
    assert got == want


def test_peak_flops_by_card_name():
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert peak_flops("NVIDIA H100 PCIe") == 756.5e12
    assert peak_flops("NVIDIA A100-SXM4-80GB") == 0.0
    assert peak_flops(torch.device("cpu")) == 0.0


def test_watchdog_near_misses_and_beat_age():
    wd = StallWatchdog(1.0)
    wd.beat()
    wd._last -= 0.6                      # the next beat lands 0.6 s later
    wd.beat()
    wd.beat()
    assert (wd.near_miss_total, wd.beats_total) == (1, 3)
    assert wd.beat_age() < 0.5
    got = resilience_collector(SimpleNamespace(guard=None, watchdog=wd))()
    assert got["counters"] == {"watchdog_beats_total": 3,
                               "watchdog_near_misses_total": 1}


def test_flags_at_the_jax_defaults_and_checked():
    cfg = runner.parse_args([])
    assert (cfg.no_telemetry, cfg.metrics_port, cfg.profile_capture) == \
        (False, 0, 20)
    cfg = runner.parse_args(["--no-telemetry", "--metrics-port", "9100",
                             "--profile-capture", "3"])
    assert (cfg.no_telemetry, cfg.metrics_port, cfg.profile_capture) == \
        (True, 9100, 3)
    for bad in (["--metrics-port", "70000"], ["--profile-capture", "-1"]):
        with pytest.raises(ValueError):
            runner.parse_args(bad)


SHM_COUNTERS = ("input_train_worker_respawns_total",
                "input_train_ring_stall_sweeps_total",
                "input_train_ring_collect_wait_seconds_total")
SHM_GAUGES = ("input_train_workers_alive", "input_train_ring_occupancy")


def test_shm_counters_and_gauges():
    """The JAX collector's shm metric names, read only off a host loader
    with a ``ring_depth``: respawns, stall sweeps and collect wait, the
    live workers and the ring's occupancy."""
    from deepfake_detection_tpu_torch.data.dataset import SyntheticDataset
    from deepfake_detection_tpu_torch.data.loader import create_loader
    loaders = {b: create_loader(SyntheticDataset(16, (16, 16, 12)), 4, True,
                                "cpu", img_num=4, num_workers=2,
                                loader_backend=b)
               for b in ("thread", "shm")}
    try:
        thread = loader_collector(loaders["thread"])()
        assert not set(SHM_COUNTERS) & set(thread["counters"])
        assert not set(SHM_GAUGES) & set(thread["gauges"])
        shm = loaders["shm"]
        shm.set_epoch(0)
        it = iter(shm)
        next(it)
        live = loader_collector(shm)()
        assert live["gauges"]["input_train_workers_alive"] == 2.0
        assert 0.0 <= live["gauges"]["input_train_ring_occupancy"] <= 1.0
        assert sum(1 for _ in it) == 3
        got = loader_collector(shm)()
        c, g = got["counters"], got["gauges"]
        assert c["input_train_worker_respawns_total"] == 0
        assert c["input_train_ring_stall_sweeps_total"] == 0
        assert c["input_train_ring_collect_wait_seconds_total"] > 0.0
        assert c["input_train_batches_total"] == 4
        assert g["input_train_ring_occupancy"] == 0.0     # epoch drained
        shm.close()
        assert loader_collector(shm)()["gauges"][
            "input_train_workers_alive"] == 0.0
    finally:
        loaders["shm"].close()


def test_metrics_endpoint_scrape_and_healthz():
    t = TrainTelemetry()
    t.on_step(8, 0.001, 0.02)
    t.on_drain(epoch=3, batch_idx=5, num_updates=17, loss=0.25, prec1=90.0,
               lr=1e-4, drain_wait_s=0.001)
    server = start_metrics_server(t, host="127.0.0.1", port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=TIMEOUT).read().decode()
        assert "# TYPE dfd_train_step_seconds histogram" in body
        assert "dfd_train_update 17" in body
        health = urllib.request.urlopen(base + "/healthz",
                                        timeout=TIMEOUT).read().decode()
        assert health.startswith("ok") and "epoch=3" in health
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=TIMEOUT)
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_file_trigger_gives_one_bounded_capture(tmp_path):
    cap = ProfilerCapture(str(tmp_path), num_steps=2)
    trigger = tmp_path / "PROFILE"
    trigger.touch()
    cap.poll()
    x = torch.ones(4)
    cap.on_step(10, x)                   # starts the window: a warm-up step
    assert cap.active and not trigger.exists()
    for i in (11, 12):                   # the two recorded steps
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        cap.on_step(i, x)
        assert cap.active
    cap.on_step(13, x)                   # 13 >= 10 + 1 + 2: stops, writes
    assert not cap.active and cap.captures_total == 1
    trace = tmp_path / "profile" / "ondemand-10"
    assert (trace / "trace.json").stat().st_size > 0
    assert json.loads((trace / "kernels.json").read_text())["steps"] == 2
    for i in range(14, 40):              # no trigger: no second capture
        cap.on_step(i, x)
    assert cap.captures_total == 1


def test_idle_profiler_is_inert(tmp_path):
    cap = ProfilerCapture(str(tmp_path), num_steps=5)
    for i in range(100):
        cap.on_step(i)
    cap.poll()
    assert not cap.active and cap.captures_total == 0
    assert not (tmp_path / "profile").exists()


_HANDLER_PROBE = r"""
import json, logging, os, signal, sys, threading, time
logging.basicConfig(level=logging.INFO)
from deepfake_detection_tpu_torch.obs.profiler import ProfilerCapture
cap = ProfilerCapture(sys.argv[1], num_steps=1)
assert cap.install()
held, release = threading.Event(), threading.Event()
locks = [h.lock for h in logging.getLogger().handlers if h.lock]
locks.append(logging._lock)

def holder():
    for lock in locks:
        lock.acquire()
    held.set()
    release.wait(60)
    for lock in reversed(locks):
        lock.release()

threading.Thread(target=holder, daemon=True).start()
held.wait(60)
os.kill(os.getpid(), signal.SIGUSR2)
deadline = time.monotonic() + 30
while not cap._want and time.monotonic() < deadline:
    time.sleep(0.001)
release.set()
print(json.dumps({"want": cap._want}))
"""


def test_signal_handler_takes_no_lock(tmp_path):
    """SIGUSR2 lands while another thread holds every lock logging owns:
    a handler that logged (or set an Event) would block the main thread
    for good; this one only sets a flag."""
    proc = subprocess.run([sys.executable, "-c", _HANDLER_PROBE,
                           str(tmp_path)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"want": True}


# ---------------------------------------------------------------------------
# the train loop: host reads per drain, telemetry on and off
# ---------------------------------------------------------------------------

_READS = ("__float__", "item", "tolist", "cpu", "numpy", "__bool__")


def _loop(telemetry):
    torch.manual_seed(0)
    model = create_model("efficientnet_b0", num_classes=2, in_chans=3,
                         device="cpu")
    cfg = SimpleNamespace(opt="sgd", opt_eps=1e-8, momentum=0.9,
                          weight_decay=0.0, lr=1e-3, log_interval=2,
                          recovery_interval=0)
    state = create_train_state(model, create_optimizer(cfg, model, 1e-3))
    step = make_train_step(cross_entropy)
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.normal(size=(4, 3, 32, 32)).astype(
        np.float32)), torch.from_numpy(np.arange(4) % 2)) for _ in range(5)]
    return train_one_epoch(0, step, state, batches, cfg,
                           telemetry=telemetry)


def test_telemetry_adds_no_host_read_and_takes_host_floats(monkeypatch):
    counts = {"n": 0}
    for name in _READS:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, **k):
            counts["n"] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    _loop(None)
    baseline, counts["n"] = counts["n"], 0
    seen = []

    class Checked(TrainTelemetry):
        def on_step(self, n, data_wait_s, step_wall_s):
            seen.extend(map(type, (n, data_wait_s, step_wall_s)))
            super().on_step(n, data_wait_s, step_wall_s)

        def on_drain(self, **kw):
            seen.extend(type(v) for v in kw.values())
            super().on_drain(**kw)

    t = Checked()
    _loop(t)
    assert counts["n"] == baseline, "telemetry read a tensor back"
    assert not any(issubclass(tp, torch.Tensor) for tp in seen)
    snap = t.snapshot()["counters"]
    assert snap["steps_total"] == 5 and snap["drains_total"] == 3


# ---------------------------------------------------------------------------
# a live CPU train run
# ---------------------------------------------------------------------------

def test_live_run_scrape_profile_and_report(tmp_path):
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = runner.parse_args(RUN_ARGS + [
        "--output", str(tmp_path), "--experiment", "run", "--metrics-port",
        str(port), "--profile-capture", "2"])
    run_dir = tmp_path / "run"
    got, done = {}, threading.Event()

    def watch():
        deadline = time.monotonic() + TIMEOUT
        while not done.is_set() and time.monotonic() < deadline:
            if "profile" not in got and (run_dir / "telemetry.jsonl").exists():
                (run_dir / "PROFILE").touch()
                got["profile"] = True
            if "metrics" not in got:
                try:
                    body = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=5).read().decode()
                except OSError:
                    body = ""
                for line in body.splitlines():
                    if line.startswith("dfd_train_steps_total ") and \
                            float(line.split()[1]) >= 1:
                        got["metrics"] = body
            time.sleep(0.01)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    try:
        result = runner.main(cfg)
    finally:
        done.set()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert "dfd_train_mfu" in got.get("metrics", ""), "never scraped mid-run"
    assert "dfd_train_input_train_batches_total" in got["metrics"]
    recs = read_records(str(run_dir / "telemetry.jsonl"))
    metrics = [r for r in recs if r["type"] == "metrics"]
    events = [r["event"] for r in recs if r["type"] == "event"]
    assert len(metrics) == len(result["train"]["step_s"]) == 8
    assert events[0] == "run_start" and events[-1] == "run_end"
    assert {"profile_capture", "epoch_end"} <= set(events)
    caps = list((run_dir / "profile").glob("ondemand-*"))
    assert len(caps) == 1 and not (run_dir / "PROFILE").exists()
    assert json.loads((caps[0] / "kernels.json").read_text())["steps"] == 2
    for m in metrics:
        assert m["data_wait_frac"] + m["device_wait_frac"] + \
            m["host_frac"] == pytest.approx(1.0, abs=2e-4)
        assert m["mfu"] == 0.0                    # no peak rate on the CPU
    report = subprocess.run(
        [sys.executable, str(REPO / "tools" / "obs_report.py"), str(run_dir)],
        capture_output=True, text=True, timeout=TIMEOUT, check=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert "imgs/s" in report.stdout and "| 0 |" in report.stdout
    assert "profile_captures_total = 1" in report.stdout
    assert "mesh: batch=1 × model=1 (1 device)" in report.stdout


def test_no_telemetry_writes_nothing(tmp_path):
    result = runner.main(runner.parse_args(RUN_ARGS + [
        "--output", str(tmp_path), "--experiment", "run",
        "--no-telemetry"]))
    assert len(result["train"]["step_s"]) == 8
    assert not (tmp_path / "run" / "telemetry.jsonl").exists()
