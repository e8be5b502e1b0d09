"""The port's runners stop on SIGTERM whatever the moment it lands.

Each runner's ``main`` sets a stop event from its signal handler, and the
handler runs in the main thread.  ``Event.set`` takes the event's lock, so
a main thread waiting on that same event (``stop.wait``) deadlocked the
process for good whenever the signal landed while ``wait`` held the lock: a
router so hung ignored SIGTERM for 45 minutes in a CPU rehearsal of
``chip_smoke.py``'s router phase.  Here the stop event's first ``wait``
sends SIGTERM to its own process while it holds the lock, the unlucky
timing made certain; each runner must still exit with its code, in a fresh
interpreter, on the CPU.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from deepfake_detection_tpu_torch.backfill import LeaseDir
from deepfake_detection_tpu_torch.backfill.manifest import (
    build_manifest_from_pack, save_manifest)
from deepfake_detection_tpu_torch.data.packed import write_pack

REPO = Path(__file__).resolve().parent.parent

#: runs ``<module>.main(argv)`` with the module's first ``threading.Event``
#: (its stop event) trapped: the first ``wait`` on it signals the process
#: while holding the event's lock
_TRAPPED = r"""
import importlib, os, signal, sys, threading, types
mod = importlib.import_module(sys.argv[1])

class TrapEvent(threading.Event):
    def wait(self, timeout=None):
        if not getattr(self, "sprung", False):
            self.sprung = True
            with self._cond:
                os.kill(os.getpid(), signal.SIGTERM)
        return super().wait(timeout)

made = []
def event():
    made.append((TrapEvent if not made else threading.Event)())
    return made[-1]

proxy = types.SimpleNamespace(**vars(threading))
proxy.Event = event
mod.threading = proxy
sys.exit(mod.main(sys.argv[2:]))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _up(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=2) as r:
            return r.status == 200
    except (urllib.error.URLError, ConnectionError, OSError):
        return False


def _tenant_corpus(tmp_path):
    """A 4-clip pack whose every shard a peer holds: the worker idles."""
    root, pack, out = tmp_path / "root", tmp_path / "pack", tmp_path / "run"
    rng = np.random.default_rng(3)
    for kind in ("fake", "real"):
        for c in range(2):
            d = root / kind / f"c{c}"
            d.mkdir(parents=True)
            for i in range(2):
                np.save(d / f"{i}.npy",
                        rng.integers(0, 256, (32, 32, 3), np.uint8))
        (root / f"{kind}_list.txt").write_text("c0:2\nc1:2\n")
    write_pack(str(root), str(pack), frames_per_clip=2, shard_size=8,
               workers=1)
    manifest = build_manifest_from_pack(str(pack), shard_clips=2)
    save_manifest(str(tmp_path / "m.json"), manifest)
    peer = LeaseDir(str(out), owner="peer", ttl_s=3600.0)
    assert all(peer.acquire(sh["id"]) for sh in manifest["shards"])
    return ["--manifest", str(tmp_path / "m.json"), "--out", str(out),
            "--data-packed", str(pack), "--model", "efficientnet_b0",
            "--batch-size", "2", "--workers", "1", "--device", "cpu",
            "--worker-name", "w"], out


@pytest.mark.parametrize("runner", ["router", "serve", "stream", "backfill"])
def test_sigterm_while_the_stop_event_is_locked(runner, tmp_path):
    port = _free_port()
    argv = {
        "router": ["--port", str(port), "--replicas",
                   f"127.0.0.1:{_free_port()}"],
        "serve": ["--port", str(port), "--device", "cpu", "--image-size",
                  "32", "--buckets", "1", "--watchdog-timeout-s", "0"],
        "stream": ["--port", str(port), "--device", "cpu", "--model",
                   "efficientnet_b0", "--image-size", "32", "--img-num",
                   "2", "--buckets", "1"],
    }.get(runner)
    want_rc = 0
    if runner == "backfill":
        argv, out = _tenant_corpus(tmp_path)
        want_rc = 75

        def ready():
            log = out / "telemetry-w.jsonl"
            return log.exists() and any(
                json.loads(ln).get("event") == "run_start"
                for ln in log.read_text().splitlines())
    else:
        def ready():
            return _up(port, "/healthz")
    proc = subprocess.Popen(
        [sys.executable, "-c", _TRAPPED,
         f"deepfake_detection_tpu_torch.runners.{runner}"] + argv,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not ready():
            assert proc.poll() is None, proc.stderr.read().decode()[-3000:]
            assert time.monotonic() < deadline, f"{runner} never started"
            time.sleep(0.1)
        time.sleep(1.5)                 # past the first wait of its loop
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == want_rc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
