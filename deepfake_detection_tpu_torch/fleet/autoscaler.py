"""SLO-driven fleet autoscaler + the two-tenant elastic scheduler.

The fleet tier built the mechanisms — :class:`~.controller.ReplicaProcess`
spawn/stop, health scraping, live stream migration — and left a human
deciding how many replicas run.  This module closes the loop:

* :class:`FleetSampler` folds the signals the router already has — its
  OWN ``dfd_router_latency_seconds{stage="total"}`` histogram (p99 over
  the sample window, from bucket deltas), its shed/routed books, and the
  per-replica queue depth / inflight / breaker state the
  :class:`~.controller.HealthScraper` scrapes — into one
  :class:`FleetSample` per control tick.  No new instrumentation in the
  engine; the sample is a pure read of existing counters.

* :class:`ScalePolicy` turns the sample stream into decisions
  **deterministically**: hysteresis bands (a breach band that must hold
  for ``up_samples`` consecutive ticks, an idle band that must hold for
  ``down_samples``, a dead band between them where nothing moves),
  cooldowns measured in *sample time* (``sample.t`` deltas, never a
  fresh wall-clock read), and capacity guards (never above
  ``max_replicas``, never below ``min_replicas``, never a second spawn
  while one is still warming).  ``decide()`` is a pure function of the
  sample sequence: replaying a recorded trace through a fresh policy
  yields bit-identical decisions (:func:`replay_trace`, pinned by the
  golden-trace test and asserted live by the chaos drive).

* :class:`Autoscaler` is the actuator: *up* spawns a
  :class:`~.controller.ReplicaProcess` (yielding a backfill worker
  first when the capacity slots are full), *down* retires the
  least-loaded ready replica through
  :func:`~.controller.retire_replica` — drain (live migration) →
  settle → terminate — so scale-in is lossless by default.  Every tick
  is recorded to a schema-stamped JSONL trace (obs/events.py idiom)
  carrying the sample AND the decision, which is what makes the
  replay check possible against a *production* run, not just a fixture.

* :class:`BackfillTenant` is the idle-capacity tenant: the fleet's
  ``max_replicas`` defines a pool of capacity slots; slots the serving
  tenant isn't using are leased through the backfill :class:`LeaseDir`
  test-and-set idiom (``<out>/_slots/leases/slot-NN.lease``) and each
  leased slot runs one ``runners/backfill.py`` worker against the
  shared manifest.  At a traffic spike the tenant **yields**: SIGTERM →
  the worker finishes its batch, releases its shard leases and exits 75
  (the existing preemption contract) → the slot lease is released and
  the serving tenant spawns into it.  Backfill books stay exact through
  any number of yields because shard leases + done markers already make
  the corpus resumable at shard granularity.

torch-free: the control loop lives in the router process, which must
never pay — or wait on — an accelerator import.  The counterpart of
``deepfake_detection_tpu/fleet/autoscaler.py``; the tenant launches the
port's ``runners/backfill.py``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shlex
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..backfill.lease import LeaseDir
from ..obs.events import EventLog, iter_records
from .controller import ReplicaProcess, free_port, http_request, \
    retire_replica
from .metrics import RouterMetrics
from .registry import Registry

_logger = logging.getLogger(__name__)

__all__ = ["FleetSample", "FleetSampler", "PolicyKnobs", "Decision",
           "ScalePolicy", "Autoscaler", "BackfillTenant", "replay_trace",
           "EXIT_PREEMPTED"]

#: the preemption exit status (mirrors runners/backfill.py, which cannot
#: be imported here — it pulls the accelerator stack): a SIGTERMed
#: backfill worker finishes its batch, releases its leases and exits 75
EXIT_PREEMPTED = 75

#: trace schema: one ``autoscale_start`` event (policy knobs) followed
#: by one ``tick`` event per control tick (sample + decision)
TRACE_SCHEMA = "dfd.fleet.autoscale.v1"


# ---------------------------------------------------------------------------
# samples
# ---------------------------------------------------------------------------

@dataclass
class FleetSample:
    """One windowed observation of the fleet — everything the policy is
    allowed to read.  All floats are pre-rounded by the sampler so the
    JSONL trace round-trips the exact values the live decision saw."""

    t: float            # sample time (monotonic seconds); cooldowns are
    # measured as deltas of THIS field, never a fresh clock read
    ready: int          # replicas healthy + /readyz-ready + not draining
    warming: int        # capacity already in flight (cold starts)
    draining: int       # replicas on their way out
    routed: int         # requests routed during the window
    shed_rate: float    # router sheds / routed over the window (0..1)
    p99_ms: float       # router total-stage p99 over the window (ms);
    # 0.0 when the window carried no traffic
    depth: float        # mean queue+inflight per ready replica
    breakers: int       # replicas with a non-closed breaker

    def to_record(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, d: Dict[str, Any]) -> "FleetSample":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _p99_ms(bounds: Sequence[float], deltas: Sequence[int]) -> float:
    """p99 (ms) of one window's worth of histogram bucket increments.

    Resolution is the bucket upper bound (the same approximation
    ``histogram_quantile`` makes); a window whose p99 lands in the +Inf
    bucket reports twice the last finite bound — a finite, monotone
    sentinel the SLO comparison can still order."""
    total = sum(deltas)
    if total <= 0:
        return 0.0
    rank = 0.99 * total
    acc = 0
    for b, c in zip(bounds, deltas):
        acc += c
        if acc >= rank:
            return round(b * 1000.0, 6)
    return round(bounds[-1] * 2 * 1000.0, 6)


class FleetSampler:
    """Builds one :class:`FleetSample` per tick from counter deltas."""

    def __init__(self, metrics: RouterMetrics):
        self.metrics = metrics
        self._prev: Optional[Tuple[int, int, List[int]]] = None

    def sample(self, registry: Registry, now: float) -> FleetSample:
        m = self.metrics
        routed = m.routed_total.value
        shed = m.shed_total.value
        hist = m.latency["total"]
        counts, _, _ = hist.snapshot()
        if self._prev is None:
            prev_routed, prev_shed = routed, shed
            prev_counts = list(counts)
        else:
            prev_routed, prev_shed, prev_counts = self._prev
        self._prev = (routed, shed, list(counts))
        droutes = max(0, routed - prev_routed)
        dshed = max(0, shed - prev_shed)
        deltas = [max(0, c - p) for c, p in zip(counts, prev_counts)]
        reps = registry.all()
        ready = [r for r in reps
                 if r.healthy and r.ready and not r.draining]
        depth = (sum(r.depth() for r in ready) / len(ready)
                 if ready else 0.0)
        return FleetSample(
            t=round(float(now), 3),
            ready=len(ready),
            warming=sum(1 for r in reps
                        if r.warming and not r.draining),
            draining=sum(1 for r in reps if r.draining),
            routed=droutes,
            shed_rate=round(dshed / droutes, 6) if droutes else 0.0,
            p99_ms=_p99_ms(hist.bounds, deltas),
            depth=round(depth, 3),
            breakers=sum(1 for r in reps if r.breaker_state),
        )


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@dataclass
class PolicyKnobs:
    """The SLO surface (RouterConfig mirrors these as ``--flags``)."""

    slo_p99_ms: float = 250.0    # the breach line
    min_replicas: int = 1
    max_replicas: int = 4
    up_samples: int = 2          # consecutive breach ticks before up
    down_samples: int = 5        # consecutive idle ticks before down
    up_cooldown_s: float = 5.0   # sample-time gap between up actions
    down_cooldown_s: float = 15.0
    shed_high: float = 0.01      # shed fraction that counts as a breach
    depth_high: float = 8.0      # per-replica depth breach line
    depth_low: float = 1.0       # per-replica depth idle line
    p99_low_frac: float = 0.5    # idle = p99 below this fraction of SLO

    def __post_init__(self):
        if int(self.min_replicas) < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{self.min_replicas}")
        if int(self.max_replicas) < int(self.min_replicas):
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if int(self.up_samples) < 1 or int(self.down_samples) < 1:
            raise ValueError("up_samples/down_samples must be >= 1")
        if not 0.0 < float(self.p99_low_frac) < 1.0:
            raise ValueError(f"p99_low_frac must be in (0,1), got "
                             f"{self.p99_low_frac}")
        if float(self.depth_low) > float(self.depth_high):
            raise ValueError("depth_low must be <= depth_high (the "
                             "hysteresis dead band)")

    @classmethod
    def from_record(cls, d: Dict[str, Any]) -> "PolicyKnobs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class Decision:
    action: str          # "up" | "down" | "hold"
    reason: str


class ScalePolicy:
    """Deterministic sample stream → decision stream.

    Hysteresis is three mechanisms stacked: (1) distinct breach and idle
    *bands* with a dead band between them — a sample in neither band
    resets both consecutive-run counters, so noise straddling a single
    threshold can never accumulate a run; (2) consecutive-sample
    requirements (``up_samples``/``down_samples``); (3) per-direction
    cooldowns measured in sample time.  State is four integers/floats —
    replaying the same samples through a fresh instance reproduces the
    same decisions exactly."""

    def __init__(self, knobs: PolicyKnobs):
        self.knobs = knobs
        self._breach_run = 0
        self._idle_run = 0
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None

    # ------------------------------------------------------------------
    def _classify(self, s: FleetSample) -> Tuple[str, str]:
        """(band, detail) — band is "breach" | "idle" | "neutral"."""
        k = self.knobs
        if s.p99_ms > k.slo_p99_ms:
            return "breach", (f"p99 {s.p99_ms:.3f}ms > slo "
                              f"{k.slo_p99_ms:.3f}ms")
        if s.shed_rate > k.shed_high:
            return "breach", (f"shed rate {s.shed_rate:.4f} > "
                              f"{k.shed_high:.4f}")
        if s.depth > k.depth_high:
            return "breach", (f"depth {s.depth:.3f} > "
                              f"{k.depth_high:.3f}")
        if s.breakers > 0:
            return "breach", f"{s.breakers} breaker(s) open"
        if (s.p99_ms <= k.slo_p99_ms * k.p99_low_frac
                and s.shed_rate == 0.0 and s.depth < k.depth_low):
            return "idle", (f"p99 {s.p99_ms:.3f}ms <= "
                            f"{k.slo_p99_ms * k.p99_low_frac:.3f}ms, "
                            f"no shed, depth {s.depth:.3f}")
        return "neutral", "inside the dead band"

    def decide(self, s: FleetSample) -> Decision:
        k = self.knobs
        band, detail = self._classify(s)
        if band == "breach":
            self._breach_run += 1
            self._idle_run = 0
        elif band == "idle":
            self._idle_run += 1
            self._breach_run = 0
        else:
            self._breach_run = 0
            self._idle_run = 0
        capacity = s.ready + s.warming
        # hard floor first: a fleet below min (a child died) re-spawns
        # regardless of load, still one-at-a-time and cooldown-paced
        if capacity < k.min_replicas:
            if s.warming > 0:
                return Decision("hold", f"below min ({capacity} < "
                                        f"{k.min_replicas}) but "
                                        f"{s.warming} warming")
            if (self._last_up_t is not None
                    and s.t - self._last_up_t < k.up_cooldown_s):
                return Decision("hold", "below min, in up-cooldown")
            self._last_up_t = s.t
            self._breach_run = 0
            return Decision("up", f"capacity {capacity} below min "
                                  f"{k.min_replicas}")
        if self._breach_run >= k.up_samples:
            if capacity >= k.max_replicas:
                return Decision("hold", f"breach ({detail}) but at max "
                                        f"{k.max_replicas}")
            if s.warming > 0:
                return Decision("hold", f"breach ({detail}) but "
                                        f"{s.warming} replica(s) "
                                        f"already warming")
            if (self._last_up_t is not None
                    and s.t - self._last_up_t < k.up_cooldown_s):
                return Decision("hold", f"breach ({detail}) but in "
                                        f"up-cooldown")
            self._last_up_t = s.t
            self._breach_run = 0
            return Decision("up", f"{detail} for {k.up_samples}+ "
                                  f"samples")
        if self._idle_run >= k.down_samples:
            if capacity <= k.min_replicas:
                return Decision("hold", f"idle but at min "
                                        f"{k.min_replicas}")
            if s.warming > 0:
                return Decision("hold", "idle but a replica is warming")
            if (self._last_down_t is not None
                    and s.t - self._last_down_t < k.down_cooldown_s):
                return Decision("hold", "idle but in down-cooldown")
            self._last_down_t = s.t
            self._idle_run = 0
            return Decision("down", f"{detail} for {k.down_samples}+ "
                                    f"samples")
        return Decision("hold", f"{band}: {detail} "
                                f"(runs {self._breach_run}/"
                                f"{self._idle_run})")

    # ------------------------------------------------------------------
    @classmethod
    def replay(cls, samples: Sequence[FleetSample],
               knobs: PolicyKnobs) -> List[Decision]:
        """Fresh policy over a recorded window — the determinism pin."""
        p = cls(knobs)
        return [p.decide(s) for s in samples]


def replay_trace(path: str) -> Dict[str, Any]:
    """Re-run a recorded autoscale trace through a fresh policy and
    compare: ``{"match": bool, "n": int, "recorded": [...],
    "replayed": [...], "mismatches": [...]}``.  The acceptance check for
    'scale decisions bit-reproducible from the recorded metrics trace'—
    run by the chaos drive against the live router's own trace file."""
    knobs: Optional[PolicyKnobs] = None
    samples: List[FleetSample] = []
    recorded: List[str] = []
    for rec in iter_records(path):
        if rec.get("event") == "autoscale_start":
            knobs = PolicyKnobs.from_record(rec.get("policy", {}))
        elif rec.get("event") == "tick":
            samples.append(FleetSample.from_record(rec["sample"]))
            recorded.append(rec["action"])
    if knobs is None:
        raise ValueError(f"{path}: no autoscale_start record (schema "
                         f"{TRACE_SCHEMA})")
    replayed = [d.action for d in ScalePolicy.replay(samples, knobs)]
    mismatches = [i for i, (a, b) in enumerate(zip(recorded, replayed))
                  if a != b]
    return {"match": recorded == replayed, "n": len(recorded),
            "recorded": recorded, "replayed": replayed,
            "mismatches": mismatches}


# ---------------------------------------------------------------------------
# the idle-capacity tenant
# ---------------------------------------------------------------------------

class BackfillTenant:
    """Backfill workers on the capacity slots serving isn't using.

    The slot pool is ``slot-00 .. slot-<max_replicas-1>`` under
    ``<out>/_slots`` — a :class:`LeaseDir`, so slot ownership has the
    same atomic test-and-set / TTL-steal semantics shard leases do (two
    routers pointed at one run dir cannot double-fill a slot).  Each
    held slot runs one backfill worker; ``reconcile`` is called every
    control tick with the current idle-slot count and launches/yields
    to match.  ``yield_workers`` is the spike path: SIGTERM, bounded
    wait for the exit-75 lease release, slot lease dropped."""

    def __init__(self, *, manifest: str, out: str, extra_args: str = "",
                 max_workers: int = 0, metrics: Optional[RouterMetrics]
                 = None, lease_ttl_s: float = 60.0,
                 yield_timeout_s: float = 30.0,
                 worker_cmd: Optional[List[str]] = None,
                 env: Optional[dict] = None):
        self.manifest = manifest
        self.out = out
        self.extra_args = extra_args
        self.max_workers = int(max_workers)
        self.metrics = metrics
        self.yield_timeout_s = float(yield_timeout_s)
        #: test hook: a stub command launched per slot instead of the
        #: backfill runner (must honor SIGTERM → exit 75)
        self.worker_cmd = worker_cmd
        self.env = env
        os.makedirs(out, exist_ok=True)
        self.lease = LeaseDir(os.path.join(out, "_slots"),
                              owner=f"tenant-{os.getpid()}",
                              ttl_s=lease_ttl_s)
        self.workers: Dict[str, subprocess.Popen] = {}
        self.corpus_done = False      # a worker ran the manifest dry
        self.launched = 0
        self.yields = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    @staticmethod
    def _slot_ids(n: int) -> List[str]:
        return [f"slot-{i:02d}" for i in range(max(0, int(n)))]

    def _launch_one(self, total_slots: int) -> bool:
        for slot in self._slot_ids(total_slots):
            if slot in self.workers:
                continue
            if not self.lease.acquire(slot):
                continue
            if self.worker_cmd is not None:
                cmd = list(self.worker_cmd)
            else:
                cmd = [sys.executable, "-m",
                       "deepfake_detection_tpu_torch.runners.backfill",
                       "--manifest", self.manifest, "--out", self.out,
                       "--worker-name", f"tenant-{slot}"]
                cmd += shlex.split(self.extra_args)
            _logger.info("backfill tenant: launching worker on %s: %s",
                         slot, " ".join(cmd))
            self.workers[slot] = subprocess.Popen(cmd, env=self.env)
            self.launched += 1
            if self.metrics is not None:
                self.metrics.backfill_workers_spawned_total.inc()
            return True
        return False

    def reap(self) -> None:
        """Collect exited workers; exit 0 means the corpus ran dry."""
        for slot, proc in list(self.workers.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del self.workers[slot]
            self.lease.release(slot)
            if rc == 0:
                self.corpus_done = True
                _logger.info("backfill tenant: corpus complete "
                             "(worker on %s exited 0)", slot)
            elif rc != EXIT_PREEMPTED:
                _logger.warning("backfill tenant: worker on %s exited "
                                "%d", slot, rc)

    def yield_workers(self, n: int,
                      timeout_s: Optional[float] = None) -> int:
        """SIGTERM the ``n`` highest-slot workers and wait (bounded) for
        their exit-75 lease release; returns how many exited cleanly.
        The spike contract: serving takes the slot the moment this
        returns."""
        timeout_s = self.yield_timeout_s if timeout_s is None \
            else float(timeout_s)
        victims = sorted(self.workers)[-max(0, int(n)):] if n > 0 else []
        for slot in victims:
            self.workers[slot].terminate()
        deadline = time.monotonic() + timeout_s
        clean = 0
        for slot in victims:
            proc = self.workers.pop(slot)
            try:
                rc = proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _logger.warning("backfill tenant: worker on %s ignored "
                                "SIGTERM for %.1fs — killing", slot,
                                timeout_s)
                proc.kill()
                rc = proc.wait()
            self.lease.release(slot)
            self.yields += 1
            if self.metrics is not None:
                self.metrics.backfill_yields_total.inc()
            if rc in (0, EXIT_PREEMPTED):
                clean += 1
                if rc == 0:
                    self.corpus_done = True
        if self.metrics is not None:
            self.metrics.backfill_workers = len(self.workers)
        return clean

    def ensure_room(self, idle_slots: int) -> None:
        """Yield enough workers that at most ``idle_slots`` remain —
        called by the autoscaler BEFORE it spawns into a slot."""
        self.reap()
        excess = len(self.workers) - max(0, int(idle_slots))
        if excess > 0:
            self.yield_workers(excess)

    def reconcile(self, idle_slots: int, total_slots: int) -> None:
        """Match the worker count to the idle capacity (one tick)."""
        self.reap()
        if self.corpus_done:
            target = 0
        else:
            target = max(0, int(idle_slots))
            if self.max_workers > 0:
                target = min(target, self.max_workers)
        while len(self.workers) > target:
            self.yield_workers(len(self.workers) - target)
        while len(self.workers) < target:
            if not self._launch_one(int(total_slots)):
                break
        for slot in self.workers:
            self.lease.heartbeat(slot)
        if self.metrics is not None:
            self.metrics.backfill_workers = len(self.workers)

    def stop(self) -> None:
        """Yield everything (shutdown path)."""
        self.reap()
        if self.workers:
            self.yield_workers(len(self.workers))

    def status(self) -> Dict[str, Any]:
        return {"workers": sorted(self.workers),
                "launched": self.launched, "yields": self.yields,
                "corpus_done": self.corpus_done}


# ---------------------------------------------------------------------------
# the actuator
# ---------------------------------------------------------------------------

class _Standby:
    """One fully-warmed but UNREGISTERED replica parked for promotion:
    it holds a capacity slot but is invisible to the ring, the scraper
    and the fleet gauges (neither ready nor warming) until a scale-up
    promotes it into the registry — a millisecond operation against the
    cold spawn it replaces."""

    __slots__ = ("proc", "warmed", "born_t")

    def __init__(self, proc: ReplicaProcess, born_t: float):
        self.proc = proc
        self.warmed = False
        self.born_t = born_t


class Autoscaler:
    """The control loop: sample → decide → act, one tick at a time.

    Wall clock only *schedules* ticks; every decision derives from the
    :class:`FleetSample` (whose ``t`` is recorded), so the JSONL trace
    fully determines the decision sequence (:func:`replay_trace`).
    ``tick()`` is public and takes an explicit ``now`` for tests."""

    def __init__(self, registry: Registry, metrics: RouterMetrics,
                 scraper, *, knobs: PolicyKnobs,
                 spawn_runner: str = "serve", replica_args: str = "",
                 interval_s: float = 1.0,
                 tenant: Optional[BackfillTenant] = None,
                 trace_path: str = "", migrate_timeout_s: float = 30.0,
                 settle_timeout_s: float = 20.0,
                 standby_replicas: int = 0,
                 child_env: Optional[dict] = None):
        self.registry = registry
        self.metrics = metrics
        self.scraper = scraper
        self.knobs = knobs
        self.spawn_runner = spawn_runner
        self.replica_args = replica_args
        self.interval_s = float(interval_s)
        self.tenant = tenant
        self.migrate_timeout_s = float(migrate_timeout_s)
        self.settle_timeout_s = float(settle_timeout_s)
        self.standby_replicas = int(standby_replicas)
        self.standbys: List[_Standby] = []
        self.child_env = child_env
        self.policy = ScalePolicy(knobs)
        self.sampler = FleetSampler(metrics)
        self.trace: Optional[EventLog] = \
            EventLog(trace_path) if trace_path else None
        if self.trace is not None:
            self.trace.event("autoscale_start", schema=TRACE_SCHEMA,
                             policy=dataclasses.asdict(knobs))
        self.last_decision = Decision("hold", "no ticks yet")
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Decision:
        now = time.monotonic() if now is None else now
        self._reap_lost()
        self._tend_standbys()
        sample = self.sampler.sample(self.registry, now)
        d = self.policy.decide(sample)
        self.last_decision = d
        self.ticks += 1
        if self.trace is not None:
            self.trace.event("tick", sample=sample.to_record(),
                             action=d.action, reason=d.reason)
        if d.action == "up":
            self._scale_up()
        elif d.action == "down":
            self._scale_down()
        if self.tenant is not None:
            # a parked standby HOLDS its capacity slot — the backfill
            # tenant must not fill it, or promotion would have to evict
            used = len(self.registry.ids()) + len(self.standbys)
            self.tenant.reconcile(self.knobs.max_replicas - used,
                                  self.knobs.max_replicas)
        self.metrics.autoscale_target_replicas = min(
            self.knobs.max_replicas,
            max(self.knobs.min_replicas, sample.ready + sample.warming
                + (1 if d.action == "up" else
                   -1 if d.action == "down" else 0)))
        return d

    def _reap_lost(self) -> None:
        """A spawned child that died under us (SIGKILL, OOM, crash) can
        never come back on its own port — deregister it so the ring and
        pools move on, and book it killed.  The policy's min-replicas
        floor then decides whether a replacement spawns."""
        for r in self.registry.all():
            child = r.process
            if child is None or child.alive:
                continue
            _logger.warning("replica %s: child exited %s outside "
                            "retirement — deregistering", r.id,
                            child.proc.returncode)
            self.metrics.replicas_killed_total.inc()
            self.registry.remove(r.id)

    def _tend_standbys(self) -> None:
        """Keep the parked pool at ``standby_replicas``: reap dead
        children (booked killed, same as registry corpses), poll the
        unwarmed ones until their /readyz reports phase ``ready`` (fully
        warmed — a degraded standby would demote promotion back into a
        compile wait), and replenish while capacity slots remain."""
        if self.standby_replicas <= 0 and not self.standbys:
            return
        for s in list(self.standbys):
            if not s.proc.alive:
                _logger.warning("standby %s: child exited %s — reaping",
                                s.proc.netloc, s.proc.proc.returncode)
                self.metrics.replicas_killed_total.inc()
                self.standbys.remove(s)
                continue
            if not s.warmed:
                try:
                    status, _hdrs, body = http_request(
                        s.proc.netloc, "GET", "/readyz", timeout=2.0)
                    detail = json.loads(body.decode("utf-8"))
                except (OSError, ValueError):
                    continue          # still importing/compiling
                if status == 200 and detail.get("ready") and \
                        detail.get("phase", "ready") == "ready":
                    s.warmed = True
                    _logger.info("standby %s: fully warmed in %.1fs — "
                                 "parked for promotion", s.proc.netloc,
                                 time.monotonic() - s.born_t)
        while (len(self.standbys) < self.standby_replicas
               and len(self.registry.ids()) + len(self.standbys)
               < self.knobs.max_replicas):
            if self.tenant is not None:
                used = len(self.registry.ids()) + len(self.standbys)
                self.tenant.ensure_room(
                    self.knobs.max_replicas - (used + 1))
            child = ReplicaProcess(self.spawn_runner, free_port(),
                                   self.replica_args, env=self.child_env)
            self.standbys.append(_Standby(child, time.monotonic()))
            self.metrics.replicas_spawned_total.inc()
            _logger.info("autoscaler: warming standby %s (%d/%d)",
                         child.netloc, len(self.standbys),
                         self.standby_replicas)
        self.metrics.standby_replicas = len(self.standbys)

    def _promote_standby(self) -> bool:
        """Registry-promote the oldest warmed standby: the ms-scale
        scale-up path.  Booked as a scale-up but NOT a spawn (the spawn
        was booked when the standby was parked, keeping
        spawned == retired + killed + live + standby exact)."""
        for s in list(self.standbys):
            if not (s.warmed and s.proc.alive):
                continue
            self.standbys.remove(s)
            r = self.registry.add(s.proc.netloc, process=s.proc)
            r.warming = True          # first scrape flips it ready
            self.metrics.standby_replicas = len(self.standbys)
            self.metrics.standby_promotions_total.inc()
            self.metrics.autoscale_up_total.inc()
            _logger.info("autoscaler: scale-up -> promoted standby %s",
                         r.id)
            if self.trace is not None:
                self.trace.event("standby_promoted", replica=r.id)
            return True
        return False

    def _scale_up(self) -> None:
        if self._promote_standby():
            return                    # warm path: no spawn, no compile
        used = len(self.registry.ids()) + len(self.standbys)
        if used >= self.knobs.max_replicas and self.tenant is None:
            return                     # registry still holds a corpse
        if self.tenant is not None:
            # the slot we are about to take must be free of the other
            # tenant FIRST (SIGTERM → exit-75 lease release)
            self.tenant.ensure_room(
                self.knobs.max_replicas - (used + 1))
        port = free_port()
        child = ReplicaProcess(self.spawn_runner, port,
                               self.replica_args, env=self.child_env)
        r = self.registry.add(child.netloc, process=child)
        r.warming = True              # optimistic until the first scrape
        self.metrics.replicas_spawned_total.inc()
        self.metrics.autoscale_up_total.inc()
        _logger.info("autoscaler: scale-up -> spawned %s", r.id)

    def _scale_down(self) -> None:
        owned = [r for r in self.registry.all()
                 if r.process is not None and r.ready
                 and not r.draining]
        if not owned:
            return                    # nothing we own is retirable
        victim = min(owned, key=lambda r: (r.depth(), r.id))
        _logger.info("autoscaler: scale-in -> retiring %s (drain-first)",
                     victim.id)
        self.metrics.autoscale_down_total.inc()
        report = retire_replica(
            self.registry, self.metrics, victim.id,
            migrate_timeout_s=self.migrate_timeout_s,
            settle_timeout_s=self.settle_timeout_s,
            scraper=self.scraper)
        if self.trace is not None:
            self.trace.event("retired", replica=victim.id,
                             settled=report.get("settled"),
                             killed=report.get("killed"))

    # ------------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        return {
            "enabled": True,
            "ticks": self.ticks,
            "last_action": self.last_decision.action,
            "last_reason": self.last_decision.reason,
            "target": self.metrics.autoscale_target_replicas,
            "policy": dataclasses.asdict(self.knobs),
            "books": {
                "spawned": self.metrics.replicas_spawned_total.value,
                "retired": self.metrics.replicas_retired_total.value,
                "killed": self.metrics.replicas_killed_total.value,
                "up": self.metrics.autoscale_up_total.value,
                "down": self.metrics.autoscale_down_total.value,
                "standby_promotions":
                    self.metrics.standby_promotions_total.value,
            },
            "standbys": {
                "target": self.standby_replicas,
                "parked": len(self.standbys),
                "warmed": sum(1 for s in self.standbys if s.warmed),
            },
            "tenant": (self.tenant.status()
                       if self.tenant is not None else None),
            "trace": self.trace.path if self.trace is not None else None,
        }

    # ------------------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None, "autoscaler already started"
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()

    def stop(self, stop_tenant: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        for s in self.standbys:
            s.proc.stop()
            self.metrics.replicas_killed_total.inc()
        self.standbys.clear()
        self.metrics.standby_replicas = 0
        if stop_tenant and self.tenant is not None:
            self.tenant.stop()
        if self.trace is not None:
            self.trace.event("autoscale_stop", ticks=self.ticks)
            self.trace.close()

    def _loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.tick(t0)
            except Exception:                      # noqa: BLE001
                _logger.exception("autoscaler tick failed")
            elapsed = time.monotonic() - t0
            self._stop.wait(max(0.05, self.interval_s - elapsed))
