"""Replica registry: consistent-hash stream affinity + health-derived
routing eligibility.

The fleet's routing truth lives here, deliberately torch-free and
stdlib-pure (the router tier must never pay — or wait on — an
accelerator import):

* :class:`HashRing` — classic consistent hashing with virtual nodes.
  Stream ids map to replicas through md5 points on a ring, so the
  assignment is a **pure function of the registered replica ids**:
  deterministic across router restarts (a rebooted router sends every
  live stream straight back to the replica that holds its session), and
  adding/removing one replica remaps only the key ranges adjacent to its
  virtual nodes — removal remaps EXACTLY the removed replica's keys,
  addition remaps ~1/N of everyone else's (both asserted in
  the JAX package's tests over 1k synthetic stream ids; the port's
  ring places every id where the JAX one does,
  ``tests/test_torch_fleet.py``).

* :class:`Replica` — one backend's routing state, derived ENTIRELY from
  signals the serve/stream stack already exports: ``/readyz`` (incl. the
  per-model JSON detail), breaker state + queue depth + inflight scraped
  off ``/metrics``, and the ``Retry-After`` of its own sheds.  The
  router adds exactly one piece of its own state, ``router_inflight``
  (proxied requests outstanding), so least-depth routing self-balances
  between scrapes.

The counterpart of ``deepfake_detection_tpu/fleet/registry.py``.

* :class:`Registry` — the table the router routes over: stateless
  requests go to the eligible replica with the least total depth,
  ``/streams/*`` requests follow the ring (or a migration override — a
  drained replica's streams re-pin to their migration target), and a
  replica that shed with ``Retry-After: n`` is skipped for the next
  ``n`` seconds before any failover hits it again.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["HashRing", "Replica", "Registry", "normalize_netloc"]


def _point(s: str) -> int:
    """Ring coordinate of a string: the top 8 bytes of its md5.  md5 is
    used as a uniform hash, not for security — and unlike ``hash()`` it
    is stable across interpreter restarts (PYTHONHASHSEED), which is
    what makes stream→replica assignment restart-deterministic."""
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


def normalize_netloc(url: str) -> str:
    """``http://host:port/`` / ``host:port`` → ``host:port`` (the
    replica id and dial address are the same string)."""
    u = url.strip()
    for prefix in ("http://", "https://"):
        if u.startswith(prefix):
            u = u[len(prefix):]
    u = u.rstrip("/")
    if not u or ":" not in u:
        raise ValueError(f"replica url {url!r} must carry host:port")
    host, port = u.rsplit(":", 1)
    if not host or not port.isdigit():
        raise ValueError(f"replica url {url!r} must carry host:port")
    return u


class HashRing:
    """Consistent hashing over replica ids with ``vnodes`` virtual nodes
    per replica.  Not thread-safe on its own; :class:`Registry` owns the
    lock."""

    def __init__(self, replica_ids: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []
        for rid in replica_ids:
            self.add(rid)

    def add(self, replica_id: str) -> None:
        for i in range(self.vnodes):
            bisect.insort(self._points,
                          (_point(f"{replica_id}#{i}"), replica_id))

    def remove(self, replica_id: str) -> None:
        self._points = [(p, r) for p, r in self._points
                        if r != replica_id]

    def ids(self) -> Set[str]:
        return {r for _, r in self._points}

    def assign(self, key: str,
               eligible: Optional[Set[str]] = None) -> Optional[str]:
        """First replica at/after ``key``'s ring point.  With
        ``eligible``, walk past ineligible replicas — keys homed on an
        eligible replica keep their assignment, only the ineligible
        replicas' ranges move (the bounded-churn property)."""
        if not self._points:
            return None
        i = bisect.bisect_left(self._points, (_point(key), ""))
        n = len(self._points)
        for step in range(n):
            _, rid = self._points[(i + step) % n]
            if eligible is None or rid in eligible:
                return rid
        return None


class Replica:
    """One backend's routing state (mutated by the health scraper and
    the router under the registry lock)."""

    __slots__ = ("id", "netloc", "healthy", "ready", "warming",
                 "draining", "breaker_state", "queue_depth", "inflight",
                 "router_inflight", "backoff_until",
                 "consecutive_failures", "exposition", "readiness",
                 "last_scrape_t", "process", "born_t", "ever_up")

    def __init__(self, url: str, process=None):
        self.netloc = normalize_netloc(url)
        self.id = self.netloc
        self.healthy = False         # scrape reaches the process
        self.ready = False           # /readyz said 200
        self.warming = False         # cold model warming (parseable 503
        # /readyz, or a just-spawned child whose port is not bound yet):
        # NOT down — the autoscaler must never retire a replica it just
        # spawned, and must count it toward capacity in flight
        self.draining = False        # operator drain: no new traffic
        self.breaker_state = 0       # scraped dfd_serving_breaker_state
        self.queue_depth = 0         # scraped dfd_serving_queue_depth
        self.inflight = 0            # scraped dfd_serving_inflight
        self.router_inflight = 0     # proxied requests outstanding HERE
        self.backoff_until = 0.0     # honoring the replica's Retry-After
        self.consecutive_failures = 0
        self.exposition: Optional[str] = None   # last /metrics text
        self.readiness: Optional[dict] = None   # last /readyz JSON detail
        self.last_scrape_t = 0.0
        self.process = process       # controller-spawned child (or None)
        self.born_t = time.monotonic()          # registration time: the
        # scraper's spawn-grace window is measured from here
        self.ever_up = False         # a scrape has succeeded at least
        # once (a replica that WAS up and stops answering is down, not
        # warming — the grace window only shields cold starts)

    def depth(self) -> int:
        """Load signal for least-depth routing: the replica's own queue
        + staged requests plus what this router has in flight to it."""
        return int(self.queue_depth) + int(self.inflight) + \
            int(self.router_inflight)

    def eligible(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return (self.healthy and self.ready and not self.draining
                and now >= self.backoff_until)

    def summary(self) -> dict:
        return {
            "id": self.id,
            "healthy": self.healthy,
            "ready": self.ready,
            "warming": self.warming,
            "draining": self.draining,
            "eligible": self.eligible(),
            "breaker_state": self.breaker_state,
            "queue_depth": self.queue_depth,
            "inflight": self.inflight,
            "router_inflight": self.router_inflight,
            "backoff_s": max(0.0, self.backoff_until - time.monotonic()),
            "consecutive_scrape_failures": self.consecutive_failures,
            "models": (self.readiness or {}).get("models"),
        }


class Registry:
    """The routing table: replicas + ring + migration overrides."""

    def __init__(self, urls: Iterable[str] = (), vnodes: int = 64):
        self._lock = threading.Lock()
        self.replicas: Dict[str, Replica] = {}
        self.ring = HashRing(vnodes=vnodes)
        #: stream id → replica id, written by migration (a drained
        #: replica's streams re-pin here); consulted before the ring
        self.overrides: Dict[str, str] = {}
        self._rr = 0                 # least-depth tiebreak rotation
        #: immutable membership snapshot for the lock-free hot path
        #: (the event-loop data plane routes off this tuple: a plain
        #: attribute read is atomic under the GIL, so the loop thread
        #: never takes the registry lock per request)
        self._view: Tuple[Replica, ...] = ()
        #: bumped on every membership/health edge (add/remove/down);
        #: upstream connection pools key their prune passes off it, so
        #: a retired or down-marked replica's pooled sockets are closed
        #: instead of leaking for the pool owner's lifetime
        self.generation = 0
        for url in urls:
            self.add(url)

    def _rebuild_view_locked(self) -> None:
        self._view = tuple(self.replicas[k] for k in sorted(self.replicas))
        self.generation += 1

    def bump_generation(self) -> None:
        """Signal pool owners that membership/health changed (the health
        scraper calls this on a healthy→down edge)."""
        with self._lock:
            self.generation += 1

    def view(self) -> Tuple[Replica, ...]:
        """Immutable membership snapshot (lock-free read)."""
        return self._view

    # ------------------------------------------------------------------
    def add(self, url: str, process=None) -> Replica:
        r = Replica(url, process=process)
        with self._lock:
            if r.id in self.replicas:
                raise ValueError(f"replica {r.id!r} already registered")
            self.replicas[r.id] = r
            self.ring.add(r.id)
            self._rebuild_view_locked()
        return r

    def remove(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            r = self.replicas.pop(replica_id, None)
            if r is not None:
                self.ring.remove(replica_id)
                self.overrides = {sid: rid for sid, rid
                                  in self.overrides.items()
                                  if rid != replica_id}
                self._rebuild_view_locked()
        return r

    def get(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            return self.replicas.get(replica_id)

    def all(self) -> List[Replica]:
        with self._lock:
            return [self.replicas[k] for k in sorted(self.replicas)]

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self.replicas)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def eligible(self, exclude: Set[str] = frozenset()) -> List[Replica]:
        now = time.monotonic()
        with self._lock:
            return [r for k, r in sorted(self.replicas.items())
                    if k not in exclude and r.eligible(now)]

    def pick_stateless(self,
                       exclude: Set[str] = frozenset()
                       ) -> Optional[Replica]:
        """Least-depth eligible replica (stable rotation between equal
        depths so idle fleets spread instead of pinning to one id)."""
        cands = self.eligible(exclude)
        if not cands:
            return None
        lowest = min(r.depth() for r in cands)
        tied = [r for r in cands if r.depth() == lowest]
        with self._lock:
            self._rr += 1
            return tied[self._rr % len(tied)]

    def pick_stateless_fast(self,
                            exclude: Set[str] = frozenset()
                            ) -> Optional[Replica]:
        """Lock-free :meth:`pick_stateless` for the event-loop data
        plane's hot path.  Iterates the immutable membership snapshot
        (``view()``); eligibility/depth are plain attribute reads (each
        atomic under the GIL).  Membership changes land as a whole new
        tuple, so the worst concurrent-mutation outcome is routing one
        request on a one-snapshot-stale view — never a torn read."""
        now = time.monotonic()
        best: Optional[Replica] = None
        best_depth = -1
        tied: List[Replica] = []
        for r in self._view:
            if r.id in exclude or not r.eligible(now):
                continue
            d = r.depth()
            if best is None or d < best_depth:
                best, best_depth, tied = r, d, [r]
            elif d == best_depth:
                tied.append(r)
        if best is None:
            return None
        # unlocked rotation: a lost update costs one repeated tiebreak
        # pick, not correctness
        self._rr += 1
        return tied[self._rr % len(tied)]

    def pick_stream_fast(self, stream_id: str
                         ) -> Tuple[Optional[Replica], bool]:
        """Lock-free :meth:`pick_stream` (overrides dict get + ring walk
        are individually atomic; membership churn mid-read can at worst
        route one request on a stale assignment, matching what a
        one-scrape-stale threads-plane pick already allows)."""
        rid = self.overrides.get(stream_id)
        migrated = rid is not None
        if rid is None:
            rid = self.ring.assign(stream_id)
        r = self.replicas.get(rid) if rid is not None else None
        return r, migrated

    def pick_stream(self, stream_id: str
                    ) -> Tuple[Optional[Replica], bool]:
        """(replica, migrated) for one stream request.

        A migration override (the stream was moved off a draining
        replica) wins; otherwise the ring's home assignment over ALL
        registered replicas — deterministic across router restarts.  A
        home replica that is down/draining does NOT fail over: the
        session state lives there, so the honest answer is a shed until
        it returns (or until a drain migrates the stream, which is what
        writes the override)."""
        with self._lock:
            rid = self.overrides.get(stream_id)
            migrated = rid is not None
            if rid is None:
                rid = self.ring.assign(stream_id)
            r = self.replicas.get(rid) if rid is not None else None
        return r, migrated

    def set_override(self, stream_id: str, replica_id: str) -> None:
        with self._lock:
            self.overrides[stream_id] = replica_id

    def clear_override(self, stream_id: str) -> None:
        with self._lock:
            self.overrides.pop(stream_id, None)

    def mark_shed(self, replica_id: str, retry_after_s: float) -> None:
        """Honor a replica's 429/503 Retry-After: no stateless traffic
        (and no failover retries) land on it until the window passes."""
        until = time.monotonic() + max(0.0, float(retry_after_s))
        with self._lock:
            r = self.replicas.get(replica_id)
            if r is not None and until > r.backoff_until:
                r.backoff_until = until

    def note_dispatch(self, replica_id: str, n: int = 1) -> None:
        with self._lock:
            r = self.replicas.get(replica_id)
            if r is not None:
                r.router_inflight += n

    def note_done(self, replica_id: str, n: int = 1) -> None:
        with self._lock:
            r = self.replicas.get(replica_id)
            if r is not None:
                r.router_inflight = max(0, r.router_inflight - n)

    # ------------------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        now = time.monotonic()
        with self._lock:
            reps = list(self.replicas.values())
        return {
            "replicas": len(reps),
            "healthy": sum(r.healthy for r in reps),
            "ready": sum(r.healthy and r.ready for r in reps),
            "warming": sum(r.warming for r in reps),
            "draining": sum(r.draining for r in reps),
            "eligible": sum(r.eligible(now) for r in reps),
        }
