"""Router observability: the ``dfd_router_*`` Prometheus catalog + the
per-replica re-export.

Same construction as ``serving/metrics.py`` (stdlib counters +
:class:`LatencyHistogram` through the shared ``utils/prometheus.py``
renderer; byte layout as the JAX package's).  The router's
``GET /metrics`` serves this catalog followed by every replica's
last-scraped exposition re-labeled with ``replica="<id>"``
(:func:`relabel_exposition`), so ONE scrape sees the whole fleet —
router books on top, each replica's ``dfd_serving_*`` /
``dfd_streaming_*`` catalogs underneath.

Router request books — the fleet-level mirror of the serving ledger,
asserted exactly by ``chip_smoke.py``'s router phase::

    routed == cache_hit + forwarded + migrated + shed + failed

Every proxied request resolves exactly once: ``cache_hit`` (the edge
verdict cache answered without touching a replica),
``forwarded`` (a replica answered and its response was relayed),
``migrated`` (answered by a migration-override target — the stream was
moved off a drained replica), ``shed`` (no eligible replica, or every
failover attempt shed: router-level 503 with a jittered
``Retry-After``), or ``failed`` (transport errors exhausted the
failover budget: 502).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set

from ..utils.prometheus import Counter as _Counter
from ..utils.prometheus import LatencyHistogram, PromText

__all__ = ["RouterMetrics", "STAGES", "BOOK_KINDS", "relabel_exposition"]

_PREFIX = "dfd_router"

#: sub-ms-resolving bounds (the serving/streaming catalogs' choice) —
#: proxy hops are host work and upstream latency tracks the replica
_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

STAGES = ("upstream", "total")

#: request-book resolution kinds (routed == sum of these, exactly)
BOOK_KINDS = ("cache_hit", "forwarded", "migrated", "shed", "failed")


class RouterMetrics:
    """One registry per router process."""

    def __init__(self):
        self.latency: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram(_BOUNDS) for s in STAGES}
        self.requests_total: Dict[str, _Counter] = {}   # by HTTP status
        self._requests_lock = threading.Lock()
        # fleet request books: routed == cache_hit + forwarded +
        # migrated + shed + failed holds EXACTLY (chip_smoke.py's router
        # phase asserts it after every load level and replica kill)
        self.routed_total = _Counter()
        self.cache_hit_total = _Counter()        # edge verdict-cache
        # answers: resolved at the router, no replica touched
        self.forwarded_total = _Counter()
        self.migrated_total = _Counter()
        self.shed_total = _Counter()
        self.failed_total = _Counter()
        self.retries_total = _Counter()          # failover attempts past
        # the first replica (shed/backoff/transport)
        # connection hygiene: slowloris/idle hardening + the
        # bounded-relay-buffer guard, shared by both data planes
        self.idle_closed_total = _Counter()      # connections closed on
        # a header-read or idle deadline (408/close)
        self.overflow_closed_total = _Counter()  # connections closed
        # because a stalled peer let the bounded relay buffer fill
        self.upstream_pool_closed_total = _Counter()   # pooled upstream
        # sockets closed because their replica retired or went down
        self.scrape_errors_total = _Counter()    # health-scrape failures
        self.replicas_down_total = _Counter()    # healthy -> down edges
        self.drains_total = _Counter()           # drain operations run
        self.streams_migrated_total = _Counter()
        self.migration_aborts_total = _Counter()   # restore-on-target
        # failed; the stream was restored back on its source (or, if even
        # that failed, dumped to disk — never silently lost)
        # replica lifecycle books: every spawned child resolves
        # exactly once as retired (drain-first, clean terminate) or killed
        # (the escalation fired / the child died under us)
        self.replicas_spawned_total = _Counter()
        self.replicas_retired_total = _Counter()
        self.replicas_killed_total = _Counter()
        # autoscaler decision books: acted scale decisions
        self.autoscale_up_total = _Counter()
        self.autoscale_down_total = _Counter()
        # standby pool: scale-ups served by promoting a
        # parked fully-warmed replica instead of a cold spawn
        self.standby_promotions_total = _Counter()
        # backfill tenant books: idle-capacity workers
        self.backfill_workers_spawned_total = _Counter()
        self.backfill_yields_total = _Counter()    # workers yielded at a
        # traffic spike (SIGTERM -> exit-75 lease release)
        # per-replica forward counts: (replica,) -> Counter
        self.replica_forwarded: Dict[str, _Counter] = {}
        self._replica_lock = threading.Lock()
        self.ready = False           # gauge: >= 1 eligible replica
        self.replicas = 0            # gauges, written by the scraper
        self.healthy_replicas = 0
        self.ready_replicas = 0
        self.warming_replicas = 0
        self.draining_replicas = 0
        self.autoscale_target_replicas = 0   # gauge, written by the
        # autoscaler (its current desired fleet size)
        self.standby_replicas = 0    # gauge: parked warm standbys
        # (unregistered — NOT counted in replicas/ready/warming above)
        self.backfill_workers = 0    # gauge, written by the tenant

    # ------------------------------------------------------------------
    def count_request(self, status: int) -> None:
        key = str(int(status))
        with self._requests_lock:
            c = self.requests_total.get(key)
            if c is None:
                c = self.requests_total[key] = _Counter()
        c.inc()

    def count_forward(self, replica_id: str) -> None:
        with self._replica_lock:
            c = self.replica_forwarded.get(replica_id)
            if c is None:
                c = self.replica_forwarded[replica_id] = _Counter()
        c.inc()

    def set_fleet_gauges(self, counts: Dict[str, int]) -> None:
        self.replicas = counts["replicas"]
        self.healthy_replicas = counts["healthy"]
        self.ready_replicas = counts["ready"]
        self.warming_replicas = counts.get("warming", 0)
        self.draining_replicas = counts["draining"]
        self.ready = counts["eligible"] > 0

    def books(self) -> Dict[str, int]:
        return {"routed": self.routed_total.value,
                "cache_hit": self.cache_hit_total.value,
                "forwarded": self.forwarded_total.value,
                "migrated": self.migrated_total.value,
                "shed": self.shed_total.value,
                "failed": self.failed_total.value}

    # ------------------------------------------------------------------
    def render_prometheus(self) -> str:
        doc = PromText(_PREFIX)
        counter, gauge = doc.counter, doc.gauge

        doc.header("requests_total", "Router responses by HTTP status",
                   "counter")
        with self._requests_lock:
            items = sorted((k, c.value)
                           for k, c in self.requests_total.items())
        for status, value in items:
            doc.sample("requests_total", f'{{status="{status}"}}', value)
        counter("routed_total", "Requests entering the routing path "
                "(books: routed == cache_hit + forwarded + migrated "
                "+ shed + failed)", self.routed_total.value)
        counter("cache_hit_total", "Requests resolved by the edge "
                "verdict cache (keyed on the fleet weights-epoch; no "
                "replica touched)", self.cache_hit_total.value)
        counter("forwarded_total", "Requests resolved by a replica "
                "response relayed to the client",
                self.forwarded_total.value)
        counter("migrated_total", "Requests resolved by a migration-"
                "override target (the stream was moved off a drained "
                "replica)", self.migrated_total.value)
        counter("shed_total", "Requests shed at the router (no eligible "
                "replica / every failover attempt shed): 503 + jittered "
                "Retry-After", self.shed_total.value)
        counter("failed_total", "Requests failed on transport errors "
                "after the failover budget (502)",
                self.failed_total.value)
        counter("retries_total", "Failover attempts past the first "
                "replica (upstream shed, backoff or transport error)",
                self.retries_total.value)
        counter("idle_closed_total", "Connections closed on a header-"
                "read or idle deadline (slowloris/idle hardening, both "
                "data planes)", self.idle_closed_total.value)
        counter("overflow_closed_total", "Connections closed because a "
                "stalled peer let the bounded relay buffer fill",
                self.overflow_closed_total.value)
        counter("upstream_pool_closed_total", "Pooled upstream sockets "
                "closed because their replica retired or went down",
                self.upstream_pool_closed_total.value)
        counter("scrape_errors_total", "Replica health-scrape failures",
                self.scrape_errors_total.value)
        counter("replicas_down_total", "Replica healthy->down "
                "transitions observed by the scraper",
                self.replicas_down_total.value)
        counter("drains_total", "Replica drain operations run",
                self.drains_total.value)
        counter("streams_migrated_total", "Live stream sessions moved to "
                "another replica (snapshot -> restore, books intact)",
                self.streams_migrated_total.value)
        counter("migration_aborts_total", "Stream migrations aborted "
                "(target restore failed; the session was restored back "
                "on its source or dumped to disk — never silently lost)",
                self.migration_aborts_total.value)
        counter("replicas_spawned_total", "Replica children spawned "
                "(launch + autoscaler scale-up)",
                self.replicas_spawned_total.value)
        counter("replicas_retired_total", "Replicas retired cleanly "
                "(drain-first: migrate -> settle -> terminate)",
                self.replicas_retired_total.value)
        counter("replicas_killed_total", "Replica stops that escalated "
                "to SIGKILL (or children that died under the "
                "controller)", self.replicas_killed_total.value)
        counter("autoscale_up_total", "Acted scale-up decisions "
                "(SLO breach held through the hysteresis window)",
                self.autoscale_up_total.value)
        counter("autoscale_down_total", "Acted scale-in decisions "
                "(idle held through the hysteresis window; drain-first)",
                self.autoscale_down_total.value)
        counter("standby_promotions_total", "Scale-ups served by "
                "promoting a parked warm standby into the registry "
                "(ms-scale, no spawn, no compile)",
                self.standby_promotions_total.value)
        counter("backfill_workers_spawned_total", "Backfill tenant "
                "workers launched onto idle capacity",
                self.backfill_workers_spawned_total.value)
        counter("backfill_yields_total", "Backfill tenant workers "
                "yielded at a traffic spike (SIGTERM -> exit-75 lease "
                "release)", self.backfill_yields_total.value)
        doc.header("replica_forwarded_total",
                   "Requests forwarded per replica", "counter")
        with self._replica_lock:
            rep_items = sorted((k, c.value)
                               for k, c in self.replica_forwarded.items())
        for rid, value in rep_items:
            doc.sample("replica_forwarded_total", f'{{replica="{rid}"}}',
                       value)
        gauge("ready", "1 while at least one replica is eligible "
              "(healthy + ready + not draining + not backing off)",
              int(self.ready))
        gauge("replicas", "Registered replicas", self.replicas)
        gauge("healthy_replicas", "Replicas whose scrape succeeds",
              self.healthy_replicas)
        gauge("ready_replicas", "Replicas healthy AND /readyz-ready",
              self.ready_replicas)
        gauge("warming_replicas", "Replicas warming a cold model "
              "(parseable 503 /readyz, or a spawned child inside its "
              "startup grace) — capacity in flight, NOT down",
              self.warming_replicas)
        gauge("draining_replicas", "Replicas draining (no new traffic)",
              self.draining_replicas)
        gauge("autoscale_target_replicas", "The autoscaler's current "
              "desired fleet size (0 while autoscaling is off)",
              self.autoscale_target_replicas)
        gauge("standby_replicas", "Parked fully-warmed standby replicas "
              "(unregistered: hold a capacity slot, invisible to the "
              "ring until promoted)", self.standby_replicas)
        gauge("backfill_workers", "Live backfill tenant workers on "
              "idle capacity", self.backfill_workers)
        for stage in STAGES:
            doc.histogram("latency_seconds", "Router request latency "
                          "(upstream = replica round trip, total = "
                          "socket in -> response out)",
                          self.latency[stage], labels=f'stage="{stage}"')
        return doc.render()


# ---------------------------------------------------------------------------
# per-replica re-export
# ---------------------------------------------------------------------------

def relabel_exposition(text: str, replica_id: str,
                       seen_families: Set[str]) -> List[str]:
    """One replica's exposition → lines with ``replica="<id>"`` injected
    into every sample's label set.

    ``seen_families`` dedupes ``# HELP``/``# TYPE`` headers across
    replicas (re-declaring a family's TYPE per replica would violate the
    exposition format); the caller passes one set across the whole
    aggregate render.  Unparseable lines are dropped rather than
    corrupting the document.
    """
    out: List[str] = []
    label = f'replica="{replica_id}"'
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                key = f"{parts[1]} {parts[2]}"
                if key in seen_families:
                    continue
                seen_families.add(key)
            out.append(line)
            continue
        lhs, sep, value = line.rpartition(" ")
        if not sep or not lhs:
            continue
        brace = lhs.find("{")
        if brace < 0:
            out.append(f"{lhs}{{{label}}} {value}")
        else:
            name, inner = lhs[:brace], lhs[brace + 1:].rstrip("}")
            joined = f"{label},{inner}" if inner else label
            out.append(f"{name}{{{joined}}} {value}")
    return out
