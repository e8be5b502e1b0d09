"""Dynamic micro-batcher: coalesce concurrent requests into bucket-shaped
device batches.

A copy of ``deepfake_detection_tpu/serving/batcher.py``.  The engine
holds one program per batch bucket (a captured CUDA graph on the card),
while real traffic arrives one request at a time.  The batcher sits between the HTTP threads and the
engine thread and turns arrival-order requests into batches that are

* **coalesced**: up to ``max_batch`` requests, or whatever arrived within
  ``deadline_ms`` of the first dequeued request — whichever happens first;
* **bounded**: a queue deeper than ``max_queue`` load-sheds new submits
  with :class:`QueueFull` (HTTP 429 + Retry-After) instead of growing an
  unbounded backlog whose tail can never meet its deadline;
* **deadline-aware**: requests that exceeded their per-request timeout
  while queued are failed (HTTP 504) at dequeue time, never shipped to the
  device.

Bucket padding itself lives in the engine (`serving/engine.py`); the
batcher only promises ``1 <= len(batch) <= max_batch``.
"""

from __future__ import annotations

import itertools
import logging
import queue
import random
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..cache import SingleFlight
from .resilience import jittered_retry_after

_logger = logging.getLogger(__name__)

__all__ = ["Request", "QueueFull", "DeadlineExceeded", "MicroBatcher",
           "pick_bucket"]


class QueueFull(Exception):
    """Raised by submit() when the queue is at max depth (load shedding)."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"queue full (depth {depth})")
        self.depth = depth
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """The request spent longer than its deadline waiting for the device."""


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest pre-compiled bucket that fits ``n`` rows."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{max(buckets)}")


class Request:
    """One scoring request: a preprocessed uint8 canvas plus a one-shot
    completion slot the HTTP thread blocks on.

    A stripped-down future (stdlib ``concurrent.futures.Future`` drags in
    condition-variable state we don't need): exactly one producer — the
    engine — resolves it exactly once.
    """

    _ids = itertools.count()
    # one lock for all requests: claim() is a few-ns critical section and
    # a per-instance lock would cost an allocation per HTTP request
    _claim_guard = threading.Lock()

    __slots__ = ("id", "array", "model_id", "enqueue_t", "deadline_t",
                 "timings", "on_resolve", "from_cache", "_event",
                 "_result", "_error", "_claimed")

    def __init__(self, array: Any, timeout_s: Optional[float] = None,
                 model_id: str = "default"):
        self.id = next(self._ids)
        self.array = array
        #: True when the verdict cache resolved this request (exact/near
        #: probe or coalesced rider) — callers that keep their own books
        #: (the streaming dispatcher) split cache_hit from scored on it
        self.from_cache = False
        self.model_id = model_id    # engine model-table key (per-model
        # books + compiled-program routing; "default" = primary model)
        self.enqueue_t = time.monotonic()
        self.deadline_t = (self.enqueue_t + timeout_s
                           if timeout_s and timeout_s > 0 else None)
        self.timings: dict = {}
        #: resolution fan-out hook (verdict-cache coalescing): fires once,
        #: AFTER the waiter is released, on every resolution path — score,
        #: failure, queue deadline, close() drain, watchdog recovery —
        #: because they all funnel through set_result/set_exception
        self.on_resolve: Optional[Any] = None
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._claimed = False

    def claim(self) -> bool:
        """One-shot resolution ticket: True for exactly one caller, ever.

        The request-books ledger (accepted == scored + shed + deadline +
        failed) needs every request counted EXACTLY once even when the
        engine worker and the watchdog race to resolve it — whoever wins
        the claim does both the counting and the set_result/exception."""
        with self._claim_guard:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline_t is not None and \
            (time.monotonic() if now is None else now) > self.deadline_t

    def _fire_on_resolve(self) -> None:
        cb, self.on_resolve = self.on_resolve, None
        if cb is not None:
            try:
                cb(self)
            except Exception:                       # noqa: BLE001
                # the engine worker must never die to a cache hiccup
                _logger.exception("on_resolve callback failed "
                                  "(request %d)", self.id)

    def set_result(self, value: Any) -> None:
        self._result = value
        self._event.set()
        self._fire_on_resolve()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()
        self._fire_on_resolve()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until resolved; raises the producer's exception, or
        :class:`DeadlineExceeded` if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded(f"request {self.id}: no result within "
                                   f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Bounded request queue with deadline-or-full coalescing.

    ``submit()`` is called from many HTTP threads; ``next_batch()`` from
    the single engine thread.  ``queue.Queue`` provides the blocking
    semantics; depth accounting is explicit so load-shedding reads a
    consistent value.
    """

    def __init__(self, max_batch: int = 64, deadline_ms: float = 5.0,
                 max_queue: int = 128, metrics: Optional[Any] = None,
                 retry_jitter_s: float = 2.0, cache: Optional[Any] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self.retry_jitter_s = float(retry_jitter_s)
        #: label unrouted submits carry in the per-model books; the
        #: engine overwrites it with its primary model id at start()
        self.default_model_id = "default"
        #: verdict cache (cache/store.py VerdictCache) — None disables the
        #: dedup tier entirely; submits without a content_key bypass it
        self.cache = cache
        #: ``model_id -> fingerprint`` resolver, set by ``engine.start()``
        #: (the cache key must carry the weight identity; until an engine
        #: attaches, there is no identity and the cache stays cold)
        self.fingerprint_of: Optional[Any] = None
        self._flight = SingleFlight()
        self._retry_rng = random.Random(0x5EED)
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._closed = threading.Event()

    # ------------------------------------------------------------------
    @property
    def depth(self) -> int:
        return self._depth

    def _track_depth(self, delta: int) -> int:
        with self._depth_lock:
            self._depth += delta
            d = self._depth
        if self.metrics is not None:
            self.metrics.queue_depth = d
        return d

    # ------------------------------------------------------------------
    def submit(self, array: Any,
               timeout_s: Optional[float] = None,
               model_id: Optional[str] = None,
               content_key: Optional[Tuple[str, Any]] = None) -> Request:
        """Enqueue one preprocessed request; raises :class:`QueueFull` past
        ``max_queue`` depth.  ``model_id`` routes it to one entry of the
        engine's model table (None = the primary model).

        ``content_key`` is the dedup identity ``(content_hash, phash)``
        (phash None unless near-dup is enabled).  With a cache attached
        and a weight fingerprint available, a hit resolves the request
        right here — it never enters a bucket, and by the same token
        never sheds; a miss elects a single-flight leader so N concurrent
        copies of one clip dispatch ONE inference."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        model_id = model_id or self.default_model_id
        if self.metrics is not None:
            # the books ledger: every submit attempt is accepted, then
            # resolves exactly once as cache_hit/scored/shed/deadline/
            # failed (the model= labeled books mirror each increment)
            self.metrics.accepted_total.inc()
            self.metrics.count_model("accepted", model_id)
        fp = None
        if self.cache is not None and content_key is not None \
                and self.fingerprint_of is not None:
            try:
                fp = self.fingerprint_of(model_id)
            except Exception:                       # noqa: BLE001
                fp = None       # no weight identity -> no safe cache key
        if fp is None:
            req = Request(array, timeout_s, model_id=model_id)
            self._enqueue(req)
            return req
        hit = self._probe(array, timeout_s, model_id, content_key, fp)
        if hit is not None:
            return hit
        chash, phash = content_key
        key = (chash, model_id, fp)
        req = Request(array, timeout_s, model_id=model_id)
        if not self._flight.lead_or_follow(key, req):
            # follower: never enqueued, never shed — the leader's fan-out
            # resolves and books it (cache_hit on success, the mirrored
            # deadline/failed term otherwise)
            return req
        req.on_resolve = self._make_resolver(key, chash, phash, model_id,
                                             fp)
        try:
            self._enqueue(req)
        except QueueFull as qf:
            # the leader shed before entering the queue: every follower
            # that attached in the window sheds with it (each carries an
            # accepted count that must resolve)
            for f in self._flight.pop(key):
                if f.claim():
                    if self.metrics is not None:
                        self.metrics.shed_total.inc()
                        self.metrics.count_model("shed", f.model_id)
                    f.set_exception(QueueFull(qf.depth, qf.retry_after_s))
            raise
        return req

    def _enqueue(self, req: Request) -> None:
        """Depth-checked queue insert (the pre-cache submit() body)."""
        with self._depth_lock:
            if self._depth >= self.max_queue:
                depth = self._depth
                full = True
            else:
                self._depth += 1
                depth = self._depth
                full = False
        if self.metrics is not None:
            self.metrics.queue_depth = depth
        if full:
            if self.metrics is not None:
                self.metrics.shed_total.inc()
                self.metrics.count_model("shed", req.model_id)
            # Retry-After estimate: drain time of the current backlog at
            # one deadline-window per max_batch, floored at 1s (the
            # HTTP-date alternative needs no clock sync this way), plus a
            # bounded uniform jitter — a constant here synchronizes every
            # shed client into one resend wave that sheds again
            retry = jittered_retry_after(
                max(1.0, depth / self.max_batch * self.deadline_s),
                self.retry_jitter_s, self._retry_rng)
            raise QueueFull(depth, retry)
        self._q.put(req)
        if self._closed.is_set():
            # close() raced us: its drain may have run before our put
            # landed, which would strand an accepted-counted request and
            # break the books identity — whoever wins the claim resolves
            # it (the drain, or us, exactly once)
            if req.claim():
                if self.metrics is not None:
                    self.metrics.failed_total.inc()
                    self.metrics.count_model("failed", req.model_id)
                req.set_exception(RuntimeError("batcher is closed"))

    # ----------------------------------------------------- verdict cache
    def _probe(self, array: Any, timeout_s: Optional[float],
               model_id: str, content_key: Tuple[str, Any],
               fp: str) -> Optional[Request]:
        """Exact-then-near cache probe; a hit returns a request resolved
        on the spot (claimed + booked as cache_hit, per model)."""
        chash, phash = content_key
        value = self.cache.get(chash, model_id, fp)
        near = False
        if value is None and phash is not None:
            got = self.cache.get_near(phash, model_id, fp)
            if got is not None:
                value, _dist = got
                near = True
        if value is None:
            if self.metrics is not None:
                self.metrics.cache_miss_total.inc()
            return None
        req = Request(array, timeout_s, model_id=model_id)
        req.claim()
        if self.metrics is not None:
            self.metrics.cache_hit_total.inc()
            self.metrics.count_model("cache_hit", model_id)
            if near:
                # separate counter by decree: a near hit is a different
                # clip's verdict and must never pass as an exact hit
                self.metrics.cache_near_hit_total.inc()
        req.timings["queue"] = 0.0
        req.timings["device"] = 0.0
        req.from_cache = True
        req.set_result(np.array(value, copy=True))
        return req

    def _make_resolver(self, key: Any, chash: str, phash: Any,
                       model_id: str, fp: str) -> Any:
        def _resolved(leader: Request) -> None:
            # runs on whatever thread resolved the leader (engine worker,
            # queue-deadline drop, close() drain) — pop first so late
            # arrivals elect a fresh leader instead of attaching to a
            # resolved one
            followers = self._flight.pop(key)
            err = leader._error
            row = None
            if err is None:
                # copy out of the batch array: the stored verdict must
                # outlive (and never alias) the engine's scratch
                row = np.array(leader._result, copy=True)
                self.cache.put(chash, model_id, fp, row, phash=phash)
                if self.metrics is not None:
                    self.metrics.cache_insert_total.inc()
                    self.metrics.cache_entries = self.cache.size()
            now = time.monotonic()
            for f in followers:
                if not f.claim():
                    continue
                f.timings["queue"] = now - f.enqueue_t
                if err is None:
                    if self.metrics is not None:
                        self.metrics.cache_hit_total.inc()
                        self.metrics.count_model("cache_hit", f.model_id)
                        self.metrics.cache_coalesced_total.inc()
                    f.timings["device"] = 0.0
                    f.from_cache = True
                    f.set_result(np.array(row, copy=True))
                else:
                    # mirror the leader's outcome so the books identity
                    # holds for every coalesced rider
                    if self.metrics is not None:
                        if isinstance(err, DeadlineExceeded):
                            self.metrics.deadline_total.inc()
                            self.metrics.count_model("deadline",
                                                     f.model_id)
                        else:
                            self.metrics.failed_total.inc()
                            self.metrics.count_model("failed", f.model_id)
                    f.set_exception(err)
        return _resolved

    # ------------------------------------------------------------------
    def take(self, timeout: Optional[float]) -> Optional[Request]:
        """One queue pop; drops (fails) requests that expired while queued
        and keeps popping within the same grant.  The engine uses this
        directly to gather the next batch while the device is busy."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                req = self._q.get(block=remaining is None or remaining > 0,
                                  timeout=remaining)
            except queue.Empty:
                return None
            self._track_depth(-1)
            if req.expired():
                req.timings["queue"] = time.monotonic() - req.enqueue_t
                if req.claim():
                    if self.metrics is not None:
                        self.metrics.deadline_total.inc()
                        self.metrics.count_model("deadline", req.model_id)
                    req.set_exception(DeadlineExceeded(
                        f"request {req.id} expired after "
                        f"{req.timings['queue'] * 1000:.0f} ms in queue"))
                continue
            return req

    def next_batch(self, timeout: Optional[float] = 0.1) -> List[Request]:
        """Dequeue the next batch.

        Blocks up to ``timeout`` for the FIRST request (empty list on
        timeout), then coalesces followers for up to ``deadline_ms`` —
        measured from that first dequeue — returning early once
        ``max_batch`` is reached.  (While a previous batch is still
        executing, the engine instead gathers via :meth:`take` directly,
        paced by the device rather than the clock — engine.py.)
        """
        first = self.take(timeout)
        if first is None:
            return []
        batch = [first]
        flush_at = time.monotonic() + self.deadline_s
        while len(batch) < self.max_batch:
            wait = flush_at - time.monotonic()
            nxt = self.take(max(0.0, wait))
            if nxt is None:       # flush window elapsed / queue drained
                break
            batch.append(nxt)
        now = time.monotonic()
        for r in batch:
            r.timings["queue"] = now - r.enqueue_t
        return batch

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Fail everything still queued (server shutdown)."""
        self._closed.set()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            self._track_depth(-1)
            if req.claim():
                if self.metrics is not None:
                    self.metrics.failed_total.inc()
                    self.metrics.count_model("failed", req.model_id)
                req.set_exception(RuntimeError("server shutting down"))
