"""Fleet controller: replica health scraping + optional replica process
management.

**No new instrumentation in the engine**: replica health is derived
entirely from signals the serve/stream stack already exports —

* ``GET /readyz`` — the per-model JSON readiness detail (status 503 with
  a parseable body means *cold model warming*; a connection error means
  *engine down* — the distinction the router needs to route around a
  re-warm without declaring the replica dead);
* ``GET /metrics`` — breaker state (``dfd_serving_breaker_state``),
  queue depth, inflight and the full exposition text (kept verbatim for
  the router's ``replica=``-labeled re-export).

A replica whose scrape fails ``fail_after`` consecutive times is marked
down (an open breaker or a watchdog re-warm drains traffic away much
earlier, via ready=False / breaker_state on the same scrape).

:class:`ReplicaProcess` spawns one ``runners/serve.py`` /
``runners/stream.py`` child per replica for the self-hosted topology
(``runners/router.py --spawn N``); the harnesses spawn their own
children and attach by URL instead.  The controller itself must stay
torch-free — children import the accelerator stack, the router tier
never does.  The counterpart of ``deepfake_detection_tpu/fleet/controller.py``;
:class:`ReplicaProcess` launches the port's runners.

A spawned replica's port is reserved before the child starts: the
parent binds a socket to a free port and hands it down (``pass_fds``, its
number in ``DFD_LISTEN_FD``), and the child's server adopts it
(``serving/listen.py`` says why the JAX controller's ``free_port`` could
lose the port).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import random
import shlex
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..serving.listen import LISTEN_FD_ENV
from .metrics import RouterMetrics
from .registry import Registry, Replica

_logger = logging.getLogger(__name__)

__all__ = ["HealthScraper", "ReplicaProcess", "http_request",
           "parse_exposition", "retire_replica"]

def http_request(netloc: str, method: str, path: str, body: bytes = b"",
                 headers: Optional[dict] = None, timeout: float = 5.0
                 ) -> tuple:
    """One short-lived HTTP round trip → (status, headers dict, body).
    Raises OSError on transport failure (the caller's down-detection)."""
    host, port = netloc.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body or None, headers or {})
        resp = conn.getresponse()
        data = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        return resp.status, hdrs, data
    except http.client.HTTPException as e:
        raise OSError(f"bad HTTP response from {netloc}: {e!r}") from e
    finally:
        conn.close()


def parse_exposition(text: str) -> Dict[str, float]:
    """Unlabeled samples of one exposition document → {name: value}."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 2 and "{" not in parts[0]:
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                pass
    return out


class HealthScraper:
    """One thread polling every replica's /readyz + /metrics on a fixed
    cadence (jittered — the serving stack's anti-thundering-herd idiom, so N
    routers scraping one fleet never align their bursts), folding the
    results into the registry's routing state.

    Replica state is three-valued, not two: *warming* — a
    parseable 503 ``/readyz`` (cold model warming) OR a spawned child
    whose port is not bound yet, still inside ``spawn_grace_s`` and
    never yet scraped up — is distinct from *down*.  The autoscaler
    must never retire a replica it just spawned, and must count warming
    replicas toward capacity already in flight (or every control tick
    during a cold start would spawn another child)."""

    def __init__(self, registry: Registry, metrics: RouterMetrics,
                 interval_s: float = 0.5, fail_after: int = 3,
                 timeout_s: float = 2.0, spawn_grace_s: float = 900.0):
        self.registry = registry
        self.metrics = metrics
        self.interval_s = float(interval_s)
        self.fail_after = max(1, int(fail_after))
        self.timeout_s = float(timeout_s)
        self.spawn_grace_s = float(spawn_grace_s)
        # seeded: deterministic under test, decorrelated in a fleet of
        # routers (each process seeds with its own pid)
        self._rng = random.Random(0x5C8A9E ^ (id(self) & 0xFFFF))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def scrape_once(self, r: Replica, now: Optional[float] = None) -> None:
        """Scrape one replica; mutates its routing state in place."""
        now = time.monotonic() if now is None else now
        try:
            status, _, body = http_request(
                r.netloc, "GET", "/readyz", timeout=self.timeout_s)
            try:
                readiness = json.loads(body)
            except ValueError:
                readiness = None      # pre-JSON replicas: status rules
            _, _, mtext = http_request(
                r.netloc, "GET", "/metrics", timeout=self.timeout_s)
        except OSError:
            self.metrics.scrape_errors_total.inc()
            r.consecutive_failures += 1
            child = r.process
            child_dead = child is not None and not child.alive
            if not child_dead and not r.ever_up and child is not None \
                    and (now - r.born_t) < self.spawn_grace_s:
                # a just-spawned child that has not bound its port yet:
                # warming, NOT down — fail_after must not retire a cold
                # start (satellite 2: a dead socket and a parseable 503
                # are the same thing during startup)
                r.warming = True
                return
            if (r.consecutive_failures >= self.fail_after or child_dead) \
                    and (r.healthy or r.warming):
                _logger.warning(
                    "replica %s: %s — marking DOWN", r.id,
                    "child process exited" if child_dead else
                    f"{r.consecutive_failures} consecutive scrape "
                    f"failures")
                self.metrics.replicas_down_total.inc()
                r.healthy = False
                r.ready = False
                r.warming = False
                r.exposition = None
                # pool owners prune on generation change: a down
                # replica's pooled upstream sockets close instead of
                # leaking until the pool owner's own lifetime ends
                self.registry.bump_generation()
            return
        text = mtext.decode("utf-8", "replace")
        samples = parse_exposition(text)
        was_healthy = r.healthy
        r.consecutive_failures = 0
        r.healthy = True
        r.ready = status == 200
        r.ever_up = True
        r.readiness = readiness if isinstance(readiness, dict) else None
        # a parseable 503 /readyz is a live engine warming a cold model
        r.warming = (not r.ready) and isinstance(readiness, dict)
        r.breaker_state = int(samples.get("dfd_serving_breaker_state", 0))
        r.queue_depth = int(samples.get("dfd_serving_queue_depth", 0))
        r.inflight = int(samples.get("dfd_serving_inflight", 0))
        r.exposition = text
        r.last_scrape_t = now
        if not was_healthy:
            _logger.info("replica %s: back up (ready=%s)", r.id, r.ready)

    def scrape_all(self) -> None:
        for r in self.registry.all():
            if self._stop.is_set():
                return
            self.scrape_once(r)
        self.metrics.set_fleet_gauges(self.registry.counts())

    # ------------------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None, "scraper already started"
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-health-scraper",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.scrape_all()
            except Exception:                      # noqa: BLE001
                _logger.exception("health scrape pass failed")
            elapsed = time.monotonic() - t0
            # jittered cadence: base interval + uniform [0, interval/5)
            # so N scrapers against one fleet decorrelate (the
            # jittered_retry_after idiom, seeded rng)
            jitter = self._rng.uniform(0.0, self.interval_s * 0.2)
            self._stop.wait(max(0.05, self.interval_s - elapsed) + jitter)


class ReplicaProcess:
    """One spawned replica child (serve or stream runner) on a local
    port (``port`` 0: a free one, reserved for the child before it starts;
    see the module docstring), with the terminate→kill shutdown
    escalation.

    ``stop()`` is the LAST step of retirement, not the whole of it —
    scale-in goes through :func:`retire_replica` (drain → bounded wait
    for migrations/inflight → terminate) so the lossless path is the
    default and the kill escalation is the exception it was meant to be.
    ``kill_escalated`` records whether the escalation fired (the
    ``dfd_router_replicas_killed_total`` book)."""

    RUNNERS = ("serve", "stream")

    def __init__(self, runner: str, port: int = 0, extra_args: str = "",
                 env: Optional[dict] = None):
        if runner not in self.RUNNERS:
            raise ValueError(f"runner must be one of {self.RUNNERS}, "
                             f"got {runner!r}")
        reserved = None
        if not port:
            reserved = socket.socket()
            reserved.bind(("127.0.0.1", 0))
            port = reserved.getsockname()[1]
        self.runner = runner
        self.port = int(port)
        self.extra_args = extra_args
        self.kill_escalated = False
        self.cmd = [sys.executable, "-m",
                    f"deepfake_detection_tpu_torch.runners.{runner}",
                    "--port", str(self.port)] + shlex.split(extra_args)
        _logger.info("spawning replica: %s", " ".join(self.cmd))
        # spawn timestamp for the child's cold-start stage breakdown
        # (dfd_serving_warmup_seconds{stage="spawn"}): wall-clock, since
        # monotonic clocks don't compare across processes
        child_env = dict(os.environ if env is None else env)
        child_env.setdefault("DFD_SPAWN_T", repr(time.time()))
        child_env.pop(LISTEN_FD_ENV, None)
        fds = ()
        if reserved is not None:
            child_env[LISTEN_FD_ENV] = str(reserved.fileno())
            fds = (reserved.fileno(),)
        try:
            self.proc = subprocess.Popen(self.cmd, env=child_env,
                                         pass_fds=fds)
        finally:
            if reserved is not None:
                reserved.close()       # the child holds its own copy

    @property
    def netloc(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, timeout_s: float = 15.0) -> Optional[int]:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.kill_escalated = True
                self.proc.kill()
                self.proc.wait(timeout=timeout_s)
        return self.proc.returncode


def spawn_replicas(n: int, runner: str, extra_args: str = "",
                   env: Optional[dict] = None) -> List[ReplicaProcess]:
    """``n`` replica children on reserved local ports (the --spawn
    path)."""
    return [ReplicaProcess(runner, 0, extra_args, env=env)
            for _ in range(n)]


def retire_replica(registry: Registry, metrics: RouterMetrics,
                   replica_id: str, *, migrate_timeout_s: float = 30.0,
                   settle_timeout_s: float = 20.0,
                   scraper: Optional[HealthScraper] = None,
                   stop_timeout_s: float = 15.0) -> dict:
    """Drain-first replica retirement — the lossless scale-in path.

    Order of operations (each step bounded):

    1. drain: mark the replica draining (no new traffic) and live-migrate
       its stream sessions to their ring successors (fleet/migrate.py —
       the live-migration machinery, so affine streams move with their state);
    2. settle: wait up to ``settle_timeout_s`` for the replica's own
       inflight/queue and this router's outstanding proxied requests to
       reach zero (re-scraping if a scraper is given);
    3. terminate: graceful stop of the spawned child (if the controller
       owns one), with the kill escalation counted separately
       (``dfd_router_replicas_killed_total``) from the clean retirements
       (``dfd_router_replicas_retired_total``);
    4. deregister: remove from the registry (pools prune on generation).

    Returns the retirement report (drain report nested verbatim).
    """
    r = registry.get(replica_id)
    if r is None:
        return {"error": f"unknown replica {replica_id!r}",
                "replicas": registry.ids()}
    from .migrate import drain_replica    # function-level: migrate.py
    # imports this module (http_request) — module-level would be a cycle
    try:
        drain = drain_replica(registry, metrics, replica_id,
                              timeout_s=migrate_timeout_s)
    except Exception as e:                             # noqa: BLE001
        r.draining = True             # still stop new traffic
        drain = {"error": f"drain failed: {e!r}"}
    deadline = time.monotonic() + max(0.0, float(settle_timeout_s))
    settled = False
    while True:
        if scraper is not None and r.healthy:
            scraper.scrape_once(r)
        if r.router_inflight <= 0 and \
                (not r.healthy or (r.inflight <= 0 and
                                   r.queue_depth <= 0)):
            settled = True
            break
        if time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    rc: Optional[int] = None
    killed = False
    child = r.process
    if child is not None:
        rc = child.stop(timeout_s=stop_timeout_s)
        killed = bool(getattr(child, "kill_escalated", False))
    if killed:
        metrics.replicas_killed_total.inc()
    else:
        metrics.replicas_retired_total.inc()
    registry.remove(replica_id)
    _logger.info("replica %s retired (settled=%s rc=%s killed=%s)",
                 replica_id, settled, rc, killed)
    return {"replica": replica_id, "drain": drain, "settled": settled,
            "rc": rc, "killed": killed}
