"""PyTorch port, the fleet tier against the JAX package's, on the CPU.

The port's ``fleet/`` (registry, metrics, controller, migrate, router,
dataplane, autoscaler) and ``runners/router.py`` against the JAX
package's, at a small size: stdlib stub replicas with scripted answers,
port serve replicas of the full-depth flagship at 64² (buckets 1 and 4,
``--device cpu``), port stream replicas of ``efficientnet_b0`` at 32², and
the port's backfill worker on a 24-clip pack at 32².  Every input is made
from a seed with numpy.

Tolerances: hash-ring placements, least-depth picks, status sequences,
per-replica forwards, router books, ``/readyz`` and ``/replicas``
documents (ports and time left in a back-off aside), relabelled
expositions and scale decisions are equal to the JAX fleet's; scores
through either router are bitwise the replica's and the port CLI's; a
stream migrated by a drain goes on within 1e-5 of an undrained session
(the CPU's convolutions are not bitwise across batch sizes, and a
window's bucket follows its arrival), with its verdict events and books
equal.  The router process must import no torch.
"""

import hashlib
import io
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import asdict, fields
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from deepfake_detection_tpu import params as jparams
from deepfake_detection_tpu.config import RouterConfig as JRouterConfig
from deepfake_detection_tpu.fleet import autoscaler as jauto
from deepfake_detection_tpu.fleet.controller import \
    HealthScraper as JHealthScraper
from deepfake_detection_tpu.fleet.metrics import RouterMetrics as JMetrics
from deepfake_detection_tpu.fleet.metrics import \
    relabel_exposition as j_relabel
from deepfake_detection_tpu.fleet.registry import HashRing as JHashRing
from deepfake_detection_tpu.fleet.registry import Registry as JRegistry
from deepfake_detection_tpu.fleet.router import \
    make_router_server as j_make_router
from deepfake_detection_tpu_torch import params as tparams
from deepfake_detection_tpu_torch.backfill import collect_books, load_manifest
from deepfake_detection_tpu_torch.backfill.manifest import (
    build_manifest_from_pack, save_manifest)
from deepfake_detection_tpu_torch.data.packed import write_pack
from deepfake_detection_tpu_torch.fleet import autoscaler as tauto
from deepfake_detection_tpu_torch.fleet.controller import HealthScraper
from deepfake_detection_tpu_torch.fleet.metrics import (RouterMetrics,
                                                        relabel_exposition)
from deepfake_detection_tpu_torch.fleet.registry import HashRing, Registry
from deepfake_detection_tpu_torch.fleet.router import (EdgeCache,
                                                       make_router_server)
from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
from deepfake_detection_tpu_torch.runners import serve as serve_runner
from deepfake_detection_tpu_torch.runners import stream as stream_runner
from deepfake_detection_tpu_torch.runners import test as cli
from deepfake_detection_tpu_torch.serving.config import (RouterConfig,
                                                         ServeConfig,
                                                         StreamConfig)
from test_torch_serving import _calibrate, _frame
from test_torch_streaming import MODEL as STREAM_MODEL
from test_torch_streaming import NUM as STREAM_NUM
from test_torch_streaming import SIZE as STREAM_SIZE
from test_torch_streaming import _frames, _raw, calibrated_state

torch.set_num_threads(2)

pytestmark = pytest.mark.fleet

REPO = Path(__file__).resolve().parent.parent
SIZE = 64
TIMEOUT = 30
TOL = 1e-5
FORBIDDEN = ("torch", "jax", "jaxlib", "flax", "deepfake_detection_tpu")
#: the router side: every module the router process imports
ROUTER_SIDE = (
    ["deepfake_detection_tpu_torch.fleet"]
    + [f"deepfake_detection_tpu_torch.fleet.{m}" for m in (
        "registry", "metrics", "controller", "migrate", "router",
        "dataplane", "autoscaler")]
    + [f"deepfake_detection_tpu_torch.{m}" for m in (
        "runners.router", "serving.config", "backfill.lease",
        "backfill.manifest", "backfill.writer", "obs.events", "cache",
        "serving.resilience", "utils.prometheus")])


def _http(port, method, path, body=None, headers=None, timeout=TIMEOUT):
    """(status, parsed JSON or text, headers) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw.decode(), hdrs


def _books_exact(books):
    assert books["routed"] == sum(books[k] for k in (
        "cache_hit", "forwarded", "migrated", "shed", "failed")), books


def _wait(cond, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def _start(server):
    threading.Thread(target=server.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()
    return server


# ---------------------------------------------------------------------------
# the router side imports no torch; params.resize is what it was
# ---------------------------------------------------------------------------

def test_router_side_imports_no_torch():
    probe = ("import importlib, json, sys\n"
             f"for m in {ROUTER_SIDE!r}:\n"
             "    importlib.import_module(m)\n"
             "print(json.dumps(sorted(\n"
             "    k for k in sys.modules\n"
             f"    if k.split('.')[0] in {FORBIDDEN!r})))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_params_resize_is_bitwise_what_it_was():
    """640×480 → 600×450 on seeded frames: the digest the resize gave
    before its resampler moved to ``data/resample.py``, and Pillow's."""
    h = hashlib.sha256()
    for seed in range(3):
        f = np.random.default_rng(seed).integers(0, 256, (480, 640, 3),
                                                 np.uint8)
        out = tparams.resize(f, (600, 600))
        assert out.shape == (450, 600, 3)
        np.testing.assert_array_equal(out, jparams.resize(f, (600, 600)))
        h.update(out.tobytes())
    assert h.hexdigest() == ("2159a13f9a9a4ad77ab83d2fac2947db"
                             "7ba353ffc74b916597b869842f190985")


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def test_every_jax_router_flag_parses_with_its_default():
    port = {f.name: f.default for f in fields(RouterConfig)}
    assert port == {f.name: f.default for f in fields(JRouterConfig)}
    for name, default in port.items():
        flag = "--" + name.replace("_", "-")
        argv = ["--spawn", "1", "--replicas", "127.0.0.1:9"] + (
            [flag] if isinstance(default, bool) else [f"{flag}={default}"])
        if name in ("backfill_tenant", "backfill_out"):
            argv += ["--autoscale", "--backfill-tenant=m", "--backfill-out=o"]
        elif name == "standby_replicas":
            argv += ["--autoscale"]
        got = RouterConfig.from_args(argv)
        assert getattr(got, name) == (
            True if isinstance(default, bool) else
            {"backfill_tenant": "m", "backfill_out": "o"}.get(name, default))
        assert asdict(got) == asdict(JRouterConfig.from_args(argv))


@pytest.mark.parametrize("bad", [
    dict(spawn_runner="train"), dict(spawn=-1), dict(virtual_nodes=0),
    dict(data_plane="poll"), dict(relay_workers=0),
    dict(max_buffer_bytes=100), dict(edge_cache_entries=-1),
    dict(min_replicas=3, max_replicas=2), dict(autoscale_depth_low=9.0),
    dict(standby_replicas=1), dict(scrape_interval_s=0.0),
    dict(retry_jitter_s=-1.0)])
def test_router_config_checks_match_jax(bad):
    with pytest.raises(ValueError):
        JRouterConfig(**bad)
    with pytest.raises(ValueError):
        RouterConfig(**bad)


def test_router_config_needs_a_fleet_as_jax():
    for argv in ([], ["--spawn", "1", "--backfill-tenant", "m"],
                 ["--spawn", "1", "--autoscale", "--backfill-tenant", "m"]):
        with pytest.raises(ValueError):
            JRouterConfig.from_args(argv)
        with pytest.raises(ValueError):
            RouterConfig.from_args(argv)


# ---------------------------------------------------------------------------
# routing state: the ring and least-depth picks
# ---------------------------------------------------------------------------

def test_hash_ring_places_ids_as_jax():
    rng = np.random.default_rng(11)
    ids = [f"stream-{int(v):x}" for v in rng.integers(0, 2 ** 48, 1000)]
    reps = [f"10.0.0.{i}:83{i:02d}" for i in range(6)]
    for members in (reps[:4], reps[:3], reps[:3] + reps[4:6]):
        ring, jring = HashRing(members), JHashRing(members)
        got = [ring.assign(s) for s in ids]
        assert got == [jring.assign(s) for s in ids]
        assert set(got) == set(members)
        eligible = set(members[1:])
        assert [ring.assign(s, eligible) for s in ids] == \
            [jring.assign(s, eligible) for s in ids]


def test_least_depth_picks_match_jax():
    """A seeded script of registry states (depths, router inflight,
    back-offs, health, drains, overrides): every pick equal."""
    urls = [f"127.0.0.1:{9000 + i}" for i in range(4)]
    port, jax = Registry(urls), JRegistry(urls)
    rng = random.Random(0xF1EE7)
    for step in range(300):
        for rid in urls:
            state = dict(queue_depth=rng.choice([0, 0, 1, 2, 5]),
                         inflight=rng.choice([0, 1]),
                         router_inflight=rng.choice([0, 0, 1]),
                         healthy=rng.random() > 0.1,
                         ready=rng.random() > 0.1,
                         draining=rng.random() < 0.1,
                         backoff_until=(time.monotonic() + 60
                                        if rng.random() < 0.1 else 0.0))
            for reg in (port, jax):
                for k, v in state.items():
                    setattr(reg.get(rid), k, v)
        exclude = set(rng.sample(urls, rng.choice([0, 0, 1])))
        sid = f"s{rng.randrange(50)}"
        if rng.random() < 0.05:
            port.set_override(sid, urls[step % 4])
            jax.set_override(sid, urls[step % 4])

        def ids(picks):
            return [None if r is None else r.id for r in picks]

        assert ids([port.pick_stateless(exclude),
                    port.pick_stateless_fast(exclude)]) == \
            ids([jax.pick_stateless(exclude),
                 jax.pick_stateless_fast(exclude)])
        a, b = port.pick_stream(sid), jax.pick_stream(sid)
        assert (a[0].id, a[1]) == (b[0].id, b[1])
        assert port.counts() == jax.counts()


def test_edge_epoch_follows_every_scraped_fingerprint():
    """Each scrape replaces a replica's readiness document; a reload moves
    its fingerprint and so the edge cache's epoch.  An epoch memo keyed on
    ``id()`` of the last document alone kept the old epoch once a later
    document took the freed one's address, and served the old weights'
    verdicts (the JAX package's ``EdgeCache``; ``chip_smoke.py``'s router
    phase met it on the CPU).  Here a new document is allocated until it
    lands where the memo's freed one was, if it can.  The memo also
    follows health and readiness, which the epoch reads."""
    registry = Registry(["127.0.0.1:9"])
    r = registry.get("127.0.0.1:9")
    r.healthy = r.ready = True
    cache = EdgeCache(registry, 16, 60.0)

    def doc(fp):                 # the outer dict first: it takes the
        d = {}                   # address freed last, if any
        d["models"] = {"m": {"fingerprint": fp}}
        return d

    def want(fp):
        return hashlib.sha256(f"m={fp}".encode()).hexdigest()

    for i in range(20):
        r.readiness = doc(f"old{i}")
        assert cache.epoch() == want(f"old{i}")
        freed = id(r.readiness)
        r.readiness = None
        keep = []
        while len(keep) < 1000:
            keep.append(doc(f"new{i}"))
            if id(keep[-1]) == freed:
                break
        r.readiness = keep[-1]
        assert cache.epoch() == want(f"new{i}"), i
    r.ready = False
    assert cache.epoch() is None


# ---------------------------------------------------------------------------
# stub replicas with scripted answers, both routers, both data planes
# ---------------------------------------------------------------------------

class _Stub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, obj, extra=None):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/readyz":
            self._send(200, {"ready": True, "phase": "ready", "models": {
                "m": {"warmed": True, "fingerprint": "fp-0"}}})
        elif self.path == "/metrics":
            raw = (b"# TYPE dfd_serving_queue_depth gauge\n"
                   b"dfd_serving_queue_depth 0\n"
                   b"dfd_serving_inflight 0\n"
                   b"dfd_serving_breaker_state 0\n")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)
        else:
            self._send(404, {"error": "no route"})

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        st = self.server.state
        mode = st["script"].pop(0) if st["script"] else "ok"
        st["seen"].append(mode)
        if mode == "reset":
            self.close_connection = True
            self.connection.shutdown(socket.SHUT_RDWR)
        elif mode == "ok":
            self._send(200, {"fake_score": 0.25, "rank": st["rank"]})
        else:
            code, ra = mode.split("/")
            self._send(int(code), {"error": "stub shedding"},
                       {"Retry-After": ra})


#: per stub, by rank (sorted replica id): the answers to its /score posts
SCRIPTS = (["ok", "429/0", "ok", "reset", "503/0", "ok", "ok", "429/0",
            "503/0", "reset", "ok", "503/30"],
           ["ok", "ok", "503/0", "429/0", "ok", "reset", "reset", "ok",
            "503/0", "ok", "429/0", "ok"])


def _stub_fleet(router_mod, plane):
    """Two scripted stubs + a router built from ``router_mod`` (the port's
    or the JAX package's classes)."""
    make, registry_cls, metrics_cls, scraper_cls = router_mod
    stubs = []
    for _ in range(2):
        s = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
        s.daemon_threads = True
        s.handle_error = lambda *a: None
        stubs.append(_start(s))
    stubs.sort(key=lambda s: f"127.0.0.1:{s.server_address[1]}")
    for rank, s in enumerate(stubs):
        s.state = {"script": list(SCRIPTS[rank]), "seen": [], "rank": rank}
    urls = [f"127.0.0.1:{s.server_address[1]}" for s in stubs]
    registry, metrics = registry_cls(urls), metrics_cls()
    scraper = scraper_cls(registry, metrics, interval_s=0.1, fail_after=2,
                          timeout_s=2.0)
    router = make("127.0.0.1", 0, registry, metrics, scraper,
                  data_plane=plane, route_retries=2, shed_retry_after_s=1.0,
                  retry_jitter_s=2.0)
    scraper.start()
    _start(router)
    _wait(lambda: registry.counts()["eligible"] == 2, "stubs never ready")
    return stubs, urls, registry, metrics, scraper, router


def _normalized(doc, urls):
    text = json.dumps(doc, sort_keys=True)
    for rank, u in enumerate(urls):
        text = text.replace(u, f"replica-{rank}")
    out = json.loads(text)
    reps = out.get("replicas", out)
    for r in reps.values():
        r["backoff_s"] = r["backoff_s"] > 0
    return out


@pytest.mark.parametrize("plane", ["evloop", "threads"])
def test_stub_fleet_statuses_forwards_books_and_documents_match_jax(plane):
    runs = []
    for mod in ((make_router_server, Registry, RouterMetrics,
                 HealthScraper),
                (j_make_router, JRegistry, JMetrics, JHealthScraper)):
        stubs, urls, registry, metrics, scraper, router = \
            _stub_fleet(mod, plane)
        port = router.server_address[1]
        try:
            statuses = []
            for i in range(14):
                st, out, hdrs = _http(port, "POST", "/score", b"x" * (i + 1),
                                      {"Content-Type":
                                       "application/octet-stream"})
                statuses.append((st, out.get("rank"),
                                 "Retry-After" in hdrs))
            docs = [_normalized(_http(port, "GET", p)[1], urls)
                    for p in ("/readyz", "/replicas")]
            runs.append(dict(
                statuses=statuses, books=metrics.books(),
                seen=[s.state["seen"] for s in stubs],
                forwards={urls.index(k): c.value for k, c in
                          metrics.replica_forwarded.items()},
                retries=metrics.retries_total.value, docs=docs))
        finally:
            router.shutdown()
            scraper.stop()
            router.server_close()
            for s in stubs:
                s.shutdown()
                s.server_close()
    port_run, jax_run = runs
    _books_exact(port_run["books"])
    assert {s for s, _, _ in port_run["statuses"]} >= {200, 503}
    assert port_run["books"]["shed"] > 0 and port_run["retries"] > 0
    assert port_run == jax_run


def test_autoscale_golden_trace_replays_alike():
    path = str(REPO / "tests" / "fixtures" / "autoscale_trace.jsonl")
    got, want = tauto.replay_trace(path), jauto.replay_trace(path)
    assert got["match"] and got == want
    assert {"up", "down"} <= set(got["replayed"])


def test_scale_policy_decides_alike_over_seeded_samples():
    rng = random.Random(0xA5CA1E)
    knobs = dict(slo_p99_ms=100.0, min_replicas=1, max_replicas=3,
                 up_samples=2, down_samples=3, up_cooldown_s=5.0,
                 down_cooldown_s=10.0, shed_high=0.01, depth_high=8.0,
                 depth_low=1.0, p99_low_frac=0.5)
    rows = []
    for t in range(400):
        if t % 20 == 0:            # a regime a block: breach, idle or noise
            regime = rng.choice(["breach", "idle", "noise"])
        idle = regime == "idle"
        rows.append(dict(
            t=float(t), ready=rng.randint(1 if idle else 0, 3),
            warming=0 if idle else rng.randint(0, 1),
            draining=rng.randint(0, 1), routed=rng.randint(0, 80),
            shed_rate=0.0 if idle else rng.choice([0.0, 0.0, 0.02]),
            p99_ms=(rng.choice([0.0, 10.0, 40.0]) if idle else
                    rng.choice([10.0, 60.0, 150.0, 400.0])),
            depth=(rng.choice([0.1, 0.5]) if idle else
                   rng.choice([0.1, 2.0, 9.5])),
            breakers=0 if idle else rng.choice([0, 0, 0, 1])))
    got = tauto.ScalePolicy.replay([tauto.FleetSample(**r) for r in rows],
                                   tauto.PolicyKnobs(**knobs))
    want = jauto.ScalePolicy.replay([jauto.FleetSample(**r) for r in rows],
                                    jauto.PolicyKnobs(**knobs))
    assert [asdict(d) for d in got] == [asdict(d) for d in want]
    assert {d.action for d in got} == {"up", "down", "hold"}


# ---------------------------------------------------------------------------
# two port serve replicas behind the port router and the JAX router
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_flagship")
    path = d / "flagship.pth"
    torch.save(_calibrate(create_deepfake_model_v4(bn_momentum=1.0,
                                                   device="cpu"), SIZE),
               path)
    return path


def _serve_replica(ckpt):
    cfg = ServeConfig(device="cpu", port=0, image_size=SIZE, buckets=(1, 4),
                      max_queue=16, model_path=str(ckpt),
                      watchdog_timeout_s=0.0, request_timeout_ms=20000.0)
    s = serve_runner.build_server(cfg)
    s.engine.start(s.batcher)
    return _start(s)


def _close_replica(s):
    s.shutdown()
    s.engine.stop()
    s.batcher.close()
    s.server_close()


def test_scores_through_both_routers_are_the_replica_and_cli_bitwise(
        flagship_ckpt, tmp_path):
    replicas = [_serve_replica(flagship_ckpt) for _ in range(2)]
    urls = [f"127.0.0.1:{s.server_address[1]}" for s in replicas]
    routers = []
    for make, reg_cls, met_cls, scr_cls in (
            (make_router_server, Registry, RouterMetrics, HealthScraper),
            (j_make_router, JRegistry, JMetrics, JHealthScraper)):
        registry, metrics = reg_cls(urls), met_cls()
        scraper = scr_cls(registry, metrics, interval_s=0.1, fail_after=2,
                          timeout_s=5.0)
        router = make("127.0.0.1", 0, registry, metrics, scraper,
                      data_plane="evloop")
        scraper.start()
        routers.append((_start(router), registry, metrics, scraper))
    try:
        for _, registry, _, _ in routers:
            _wait(lambda: registry.counts()["eligible"] == 2,
                  "replicas never ready behind the router")
        npys = []
        for i in range(4):
            npys.append(tmp_path / f"f{i}.npy")
            np.save(npys[-1], _frame(700 + i, (90 - 9 * i, 60 + 11 * i)))
        want = cli.test_img(str(flagship_ckpt), [str(p) for p in npys],
                            size=SIZE, device="cpu")
        assert np.abs(np.asarray(want) - 0.5).max() > 1e-3, want
        ctype = {"Content-Type": "application/octet-stream"}
        for i, p in enumerate(npys):
            body = p.read_bytes()
            direct = _http(replicas[i % 2].server_address[1], "POST",
                           "/score", body, ctype)[1]["fake_score"]
            via = [_http(r.server_address[1], "POST", "/score", body,
                         ctype)[1]["fake_score"] for r, _, _, _ in routers]
            assert via == [direct, direct] and direct == want[i]
        books = [m.books() for _, _, m, _ in routers]
        assert books[0] == books[1] == dict(
            routed=4, cache_hit=0, forwarded=4, migrated=0, shed=0, failed=0)
        # a real port replica's exposition, relabelled by either package
        text = _http(replicas[0].server_address[1], "GET", "/metrics")[1]
        assert "dfd_serving_bucket_rows_total" in text
        assert relabel_exposition(text, urls[0], set()) == \
            j_relabel(text, urls[0], set())
        aggregated = [_http(r.server_address[1], "GET", "/metrics")[1]
                      for r, _, _, _ in routers]
        for agg in aggregated:
            assert f'dfd_serving_requests_total{{replica="{urls[0]}"' in agg
    finally:
        for router, _, _, scraper in routers:
            router.shutdown()
            scraper.stop()
            router.server_close()
        for s in replicas:
            _close_replica(s)


# ---------------------------------------------------------------------------
# a drain moves live stream sessions between port stream replicas
# ---------------------------------------------------------------------------

def _stream_replica(ckpt, scores):
    cfg = StreamConfig(model=STREAM_MODEL, model_path=str(ckpt),
                       image_size=STREAM_SIZE, img_num=STREAM_NUM,
                       buckets=(1, 4), device="cpu", port=0,
                       stream_ttl_s=0.0, max_inflight_windows=16)
    srv = stream_runner.build_stream_server(cfg)
    manager = srv.manager
    on_result = manager.on_result

    def recording(job, s, error):
        if s is not None:
            scores[(job.stream_id, job.track_id, job.window_idx)] = \
                float(s[0])
        on_result(job, s, error)

    manager.on_result = recording
    srv.engine.start(srv.batcher)
    srv.dispatcher.start()
    return _start(srv)


def _close_stream_replica(srv):
    srv.shutdown()
    srv.dispatcher.stop()
    srv.manager.shutdown()
    srv.engine.stop()
    srv.batcher.close()
    srv.server_close()


def _close(got, want):
    """Equal, floats within ``TOL``."""
    if isinstance(want, float):
        assert abs(got - want) <= TOL, (got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    else:
        assert got == want


def _scored(port, sid, n):
    def done():
        return _http(port, "GET", f"/streams/{sid}")[1]["counters"][
            "windows_scored"] >= n
    _wait(done, f"stream {sid} never scored {n} windows")
    return _http(port, "GET", f"/streams/{sid}")[1]


def test_drain_moves_live_stream_sessions(tmp_path):
    ckpt = tmp_path / "b0.pth"
    torch.save(calibrated_state(), ckpt)
    scores = {}
    replicas = [_stream_replica(ckpt, scores) for _ in range(2)]
    urls = [f"127.0.0.1:{s.server_address[1]}" for s in replicas]
    registry, metrics = Registry(urls), RouterMetrics()
    scraper = HealthScraper(registry, metrics, interval_s=0.1, fail_after=2,
                            timeout_s=5.0)
    router = _start(make_router_server("127.0.0.1", 0, registry, metrics,
                                       scraper, data_plane="evloop"))
    scraper.start()
    port = router.server_address[1]
    try:
        _wait(lambda: registry.counts()["eligible"] == 2, "never ready")
        homes = {}
        for i in range(64):
            homes.setdefault(registry.ring.assign(f"live-{i}"), []).append(
                f"live-{i}")
        source = next(u for u in urls if len(homes.get(u, [])) >= 2)
        sids = homes[source][:2]
        target = next(u for u in urls if u != source)
        tport = int(target.rsplit(":", 1)[1])
        head, tail = _frames(5, seed=91), _frames(7, seed=92)
        jhdr = {"Content-Type": "application/json"}
        for sid in sids:
            assert _http(port, "POST", "/streams", json.dumps(
                {"stream_id": sid}).encode(), jhdr)[0] == 201
            body, hdrs = _raw(head)
            assert _http(port, "POST", f"/streams/{sid}/frames", body,
                         hdrs)[0] == 200
        # the undrained reference: the same frames on the target itself
        assert _http(tport, "POST", "/streams", b'{"stream_id": "ref"}',
                     jhdr)[0] == 201
        for chunk in (head, tail):
            _http(tport, "POST", "/streams/ref/frames", *_raw(chunk))
        for sid in sids:
            _scored(port, sid, 2)
        st, report, _ = _http(port, "POST", f"/replicas/{source}/drain",
                              b"")
        assert st == 200 and sorted(report["migrated"]) == sorted(sids)
        assert not report["failed"]
        assert metrics.streams_migrated_total.value == 2
        for sid in sids:
            body, hdrs = _raw(tail)
            st, ack, _ = _http(port, "POST", f"/streams/{sid}/frames", body,
                               hdrs)
            assert st == 200 and ack["frames_accepted"] == 7
        ref = _scored(tport, "ref", 6)
        for sid in sids:
            got = _scored(port, sid, 6)
            assert got["counters"] == ref["counters"]
            _close(got["stream"], ref["stream"])
            strip = ("stream_id", "wall_time")
            _close([{k: v for k, v in e.items() if k not in strip}
                    for e in got["events"]],
                   [{k: v for k, v in e.items() if k not in strip}
                    for e in ref["events"]])
            assert _http(tport, "GET", f"/streams/{sid}")[0] == 200
            keys = sorted(k[1:] for k in scores if k[0] == sid)
            assert keys == sorted(k[1:] for k in scores if k[0] == "ref")
            for tid, w in keys:
                assert abs(scores[(sid, tid, w)] - scores[("ref", tid, w)]) \
                    <= TOL
        assert np.abs(np.asarray(list(scores.values())) - 0.5).max() > 1e-3
        books = metrics.books()
        _books_exact(books)
        assert books["migrated"] >= 2 and books["failed"] == 0
    finally:
        router.shutdown()
        scraper.stop()
        router.server_close()
        for s in replicas:
            _close_stream_replica(s)


# ---------------------------------------------------------------------------
# the runner in a fresh interpreter: spawn, fail over, stop every child
# ---------------------------------------------------------------------------

def _children(pid):
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
                cmd = (d / "cmdline").read_bytes().split(b"\0")
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append((int(d.name), [c.decode() for c in cmd if c]))
    return out


def _gone(pid):
    try:
        return (Path(f"/proc/{pid}/stat").read_text()
                .rsplit(")", 1)[1].split()[0]) == "Z"
    except OSError:
        return True


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_spawned_fleet_fails_over_and_stops_every_child(tmp_path):
    port = _free_port()
    args = ("--device cpu --image-size 32 --buckets 1 --max-queue 8 "
            "--watchdog-timeout-s 0 --request-timeout-ms 60000")
    log = open(tmp_path / "router.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfake_detection_tpu_torch.runners.router",
         "--spawn", "2", "--port", str(port), f"--replica-args={args}",
         "--scrape-interval-s", "0.2", "--health-fail-after", "2"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=log, stderr=subprocess.STDOUT)
    try:
        def ready():
            assert proc.poll() is None, (tmp_path / "router.log").read_text()
            try:
                st, doc, _ = _http(port, "GET", "/readyz", timeout=2)
            except (urllib.error.URLError, ConnectionError):
                return False
            return st == 200 and doc["counts"]["ready"] == 2
        _wait(ready, "the spawned fleet never became ready", timeout=120)
        kids = _children(proc.pid)
        assert len(kids) == 2
        for _, cmd in kids:
            assert cmd[1:3] == ["-m",
                                "deepfake_detection_tpu_torch.runners.serve"]
            assert "--device" in cmd and cmd[cmd.index("--device") + 1] \
                == "cpu"
        frame = np.random.default_rng(5).integers(0, 256, (40, 30, 3),
                                                  np.uint8)
        buf = io.BytesIO()
        np.save(buf, frame)
        ctype = {"Content-Type": "application/octet-stream"}
        os.kill(kids[0][0], signal.SIGKILL)
        for _ in range(6):
            st, out, _ = _http(port, "POST", "/score", buf.getvalue(), ctype)
            assert st == 200 and 0.0 <= out["fake_score"] <= 1.0

        def down():
            text = _http(port, "GET", "/metrics")[1]
            return "dfd_router_replicas_down_total 1" in text
        _wait(down, "the killed replica was never marked down")
        st, doc, _ = _http(port, "GET", "/readyz")
        assert st == 200 and doc["counts"]["healthy"] == 1
        text = _http(port, "GET", "/metrics")[1]
        vals = {k: int(float(text.split(f"\ndfd_router_{k}_total ")[1]
                             .split()[0]))
                for k in ("routed", "cache_hit", "forwarded", "migrated",
                          "shed", "failed")}
        _books_exact(vals)
        assert vals["forwarded"] == 6 and vals["failed"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert all(_gone(pid) for pid, _ in kids)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid, _ in _children(proc.pid):
            os.kill(pid, signal.SIGKILL)
        log.close()


# ---------------------------------------------------------------------------
# the backfill tenant runs the port's worker
# ---------------------------------------------------------------------------

def test_backfill_tenant_yields_and_completes_with_exact_books(tmp_path):
    root, pack, out = tmp_path / "root", tmp_path / "pack", tmp_path / "run"
    rng = np.random.default_rng(17)
    for kind, n in (("fake", 12), ("real", 12)):
        for c in range(n):
            d = root / kind / f"c{c}"
            d.mkdir(parents=True)
            for i in range(2):
                np.save(d / f"{i}.npy",
                        rng.integers(0, 256, (32, 32, 3), np.uint8))
        (root / f"{kind}_list.txt").write_text(
            "".join(f"c{c}:2\n" for c in range(n)))
    write_pack(str(root), str(pack), frames_per_clip=2, shard_size=8,
               workers=2)
    mpath = tmp_path / "manifest.json"
    save_manifest(str(mpath), build_manifest_from_pack(str(pack),
                                                       shard_clips=2))
    m = RouterMetrics()
    tenant = tauto.BackfillTenant(
        manifest=str(mpath), out=str(out), metrics=m, yield_timeout_s=60.0,
        extra_args=(f"--data-packed {pack} --model efficientnet_deepfake_v4 "
                    "--batch-size 2 --workers 1 --device cpu"),
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        tenant.reconcile(idle_slots=1, total_slots=1)
        (proc,) = tenant.workers.values()
        assert proc.args[1:3] == ["-m",
                                  "deepfake_detection_tpu_torch.runners."
                                  "backfill"]
        _wait(lambda: proc.poll() is None and (out / "leases").is_dir()
              and any((out / "leases").iterdir()),
              "the worker never leased a shard", timeout=120)
        assert tenant.yield_workers(1) == 1
        assert proc.returncode == tauto.EXIT_PREEMPTED
        assert m.backfill_yields_total.value == 1 and not tenant.corpus_done
        tenant.reconcile(idle_slots=1, total_slots=1)
        (proc,) = tenant.workers.values()
        assert proc.wait(timeout=120) == 0
        tenant.reconcile(idle_slots=1, total_slots=1)
        assert tenant.corpus_done and tenant.workers == {}
        assert m.backfill_workers_spawned_total.value == 2
        books = collect_books(str(out), load_manifest(str(mpath)))
        assert books["complete"] and books["balanced"]
        assert books["manifest_clips"] == 24 == books["scored"] + \
            books["failed"] + books["skipped_dup"]
    finally:
        tenant.stop()
