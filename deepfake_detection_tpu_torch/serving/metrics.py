"""Serving observability: per-stage latency histograms, counters, rolling
throughput, and a Prometheus text-format renderer.

A copy of ``deepfake_detection_tpu/serving/metrics.py`` with the same
``dfd_serving_*`` catalog (a fleet controller scrapes it), with one
change: the JAX backend-compile listener becomes a process-wide count of
CUDA graph captures (:func:`note_capture`), rendered under the catalog's
``backend_compiles_total`` name.  ``compiles_total`` counts the bucket
programs the engine readied: captures on the card, eager programs on the
CPU.  Everything is stdlib (:mod:`..utils.prometheus`).

Stages mirror a request's life: ``queue`` (submit → batch dispatch),
``preprocess`` (decode+resize on the HTTP thread), ``device`` (padded
bucket executes), ``total`` (socket in → response out).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Tuple

from ..utils.metrics import LatencyHistogram
from ..utils.prometheus import Counter as _Counter
from ..utils.prometheus import PromText

__all__ = ["ServingMetrics"]

_PREFIX = "dfd_serving"

# ---------------------------------------------------------------------------
# Process-wide CUDA graph capture count.  Each engine's compiles_total
# counts the programs it readied; this counter goes up on every capture
# any engine of the process makes, so a recapture after ready shows as
# growth of backend_compiles_total (the zero-recapture probe asserts its
# delta across serving is zero).
# ---------------------------------------------------------------------------

_captures = 0
_captures_lock = threading.Lock()


def note_capture() -> None:
    """One CUDA graph captured, by any engine of the process."""
    global _captures
    with _captures_lock:
        _captures += 1


def capture_count() -> int:
    """CUDA graph captures made in this process (0 on the CPU)."""
    with _captures_lock:
        return _captures

#: serving latencies cluster well under the train-loop default bounds —
#: extend down to 100 µs so queue-wait under light load still resolves
_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

STAGES = ("queue", "preprocess", "device", "total")

#: per-model request-book resolutions (the ``model=`` labeled mirror of
#: the global books: per model, accepted == cache_hit + scored + shed +
#: deadline + failed holds exactly, plus reloads for A/B observability)
MODEL_BOOK_KINDS = ("accepted", "scored", "failed", "shed", "deadline",
                    "cache_hit", "reloads")

#: cascade tiers (serving/cascade.py latency histograms)
CASCADE_TIERS = ("student", "flagship")

#: cold-start stages in pipeline order (spawn → serving): the runner
#: stamps spawn/import/params_load/ready, the engine stamps compile (its
#: eager warm runs and captures) and warm — one /metrics scrape reads the
#: whole breakdown
WARMUP_STAGES = ("spawn", "import", "params_load", "compile", "warm",
                 "ready")


class ServingMetrics:
    """One registry per server process."""

    def __init__(self, throughput_window_s: float = 30.0):
        self.latency: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram(_BOUNDS) for s in STAGES}
        self.requests_total: Dict[str, _Counter] = {}   # keyed by status
        self._requests_lock = threading.Lock()
        # request-books ledger: every submit attempt lands in accepted,
        # and every accepted request resolves EXACTLY once as cache_hit,
        # scored, shed, deadline or failed — the resilience tests assert
        # the identity accepted == cache_hit + scored + shed + deadline +
        # failed after every fault scenario
        self.accepted_total = _Counter()
        self.scored_total = _Counter()
        self.failed_total = _Counter()
        self.shed_total = _Counter()
        self.deadline_total = _Counter()
        self.batches_total = _Counter()
        self.batch_rows_total = _Counter()
        self.padded_rows_total = _Counter()
        self.compiles_total = _Counter()
        self.reloads_total = _Counter()
        self.reload_errors_total = _Counter()
        self.reload_canary_failures_total = _Counter()
        self.worker_restarts_total = _Counter()
        self.watchdog_recoveries_total = _Counter()
        self.nonfinite_batches_total = _Counter()
        self.rewarms_total = _Counter()
        self.breaker_opens_total = _Counter()
        self.breaker_probes_total = _Counter()
        self.breaker_rejected_total = _Counter()
        # verdict-cache books (the dedup tier): cache_hit is the new
        # resolution term (exact + near + coalesced); near/coalesced are
        # sub-counters, the rest is store lifecycle (never silent)
        self.cache_hit_total = _Counter()
        self.cache_near_hit_total = _Counter()
        self.cache_coalesced_total = _Counter()
        self.cache_miss_total = _Counter()
        self.cache_insert_total = _Counter()
        self.cache_expired_total = _Counter()
        self.cache_evicted_total = _Counter()
        self.cache_invalidated_total = _Counter()
        # warm-start store books (--warmstart-dir; counted at warmup by
        # serving/engine.py _warm_store, _warm_canary and _store_save):
        # every store interaction lands in exactly one of hit (a kernel
        # library or capture manifest loaded from the store), miss
        # (absent: nvcc or a fresh capture), fallback (present but
        # corrupt, foreign or version-skewed: rebuilt, loudly);
        # canary_rejects count stored entries the golden-batch canary
        # refused to let serve (also rebuilt); serialized counts entries
        # (re)written to the store
        self.warmstart_hits_total = _Counter()
        self.warmstart_misses_total = _Counter()
        self.warmstart_fallbacks_total = _Counter()
        self.warmstart_canary_rejects_total = _Counter()
        self.warmstart_serialized_total = _Counter()
        # per-stage cold-start walls (gauges, seconds): stamped once on
        # the way up, so one scrape yields the whole breakdown
        self.warmup_seconds: Dict[str, float] = {
            s: 0.0 for s in WARMUP_STAGES}
        self.chaos_injections_total: Dict[str, _Counter] = {}
        self._chaos_lock = threading.Lock()
        # per-model request books (the multi-model engine): the
        # same resolution ledger as the global books, keyed by model id
        # — (kind, model) -> Counter, kinds from MODEL_BOOK_KINDS
        self.model_books: Dict[Tuple[str, str], _Counter] = {}
        self._model_lock = threading.Lock()
        # per-(model, bucket) row accounting: (model, bucket, kind) ->
        # Counter with kind in {"real", "pad"} — the batch-size histogram
        # of a load run reads these
        self.bucket_rows: Dict[Tuple[str, int, str], _Counter] = {}
        self._bucket_lock = threading.Lock()
        # cascade books (serving/cascade.py): triaged == cleared +
        # escalated; escalated == flagship_scored + escalation_failed —
        # both identities hold EXACTLY through every fault
        self.cascade_triaged_total = _Counter()
        self.cascade_cleared_total = _Counter()
        self.cascade_escalated_total = _Counter()
        self.cascade_flagship_scored_total = _Counter()
        self.cascade_escalation_failed_total = _Counter()
        self.cascade_latency: Dict[str, LatencyHistogram] = {
            t: LatencyHistogram(_BOUNDS) for t in CASCADE_TIERS}
        self.queue_depth = 0            # gauge, written by the batcher
        self.cache_entries = 0          # gauge, written on cache inserts
        self.inflight = 0               # gauge, written by the engine
        self.ready = False              # gauge, flipped after warmup and
        # DROPPED during watchdog recovery / bucket re-warm / reload canary
        self.breaker_state = 0          # gauge (0 closed, 1 open, 2 half)
        self._window_s = float(throughput_window_s)
        self._completions: Deque[Tuple[float, int]] = collections.deque()
        self._completions_lock = threading.Lock()

    # ------------------------------------------------------------------
    def count_request(self, status: int) -> None:
        key = str(int(status))
        with self._requests_lock:
            c = self.requests_total.get(key)
            if c is None:
                c = self.requests_total[key] = _Counter()
        c.inc()

    def count_chaos(self, point: str) -> None:
        """One injected fault fired (keyed by injection-point name) —
        chaos runs must be as loudly accounted as the faults they mimic."""
        with self._chaos_lock:
            c = self.chaos_injections_total.get(point)
            if c is None:
                c = self.chaos_injections_total[point] = _Counter()
        c.inc()

    def count_model(self, kind: str, model: str, n: int = 1) -> None:
        """One per-model book resolution (``kind`` from
        MODEL_BOOK_KINDS); rides next to every global-book increment so
        the labeled ledger balances exactly like the global one."""
        key = (kind, model or "default")
        with self._model_lock:
            c = self.model_books.get(key)
            if c is None:
                c = self.model_books[key] = _Counter()
        c.inc(n)

    def model_book(self, kind: str, model: str) -> int:
        """Current value of one per-model book counter (0 if untouched)."""
        with self._model_lock:
            c = self.model_books.get((kind, model or "default"))
        return c.value if c is not None else 0

    def count_bucket_rows(self, model: str, bucket: int, real: int,
                          pad: int) -> None:
        """Real/pad row counts of one executed (model, bucket) batch."""
        model = model or "default"
        for kind, n in (("real", real), ("pad", pad)):
            if n <= 0:
                continue
            key = (model, int(bucket), kind)
            with self._bucket_lock:
                c = self.bucket_rows.get(key)
                if c is None:
                    c = self.bucket_rows[key] = _Counter()
            c.inc(n)

    def count_completion(self, n: int, now: float | None = None) -> None:
        """Record ``n`` scored requests for the rolling-throughput gauge."""
        now = time.monotonic() if now is None else now
        with self._completions_lock:
            self._completions.append((now, n))
            self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._completions and self._completions[0][0] < cutoff:
            self._completions.popleft()

    def throughput(self, now: float | None = None) -> float:
        """Scored requests/sec over the trailing window."""
        now = time.monotonic() if now is None else now
        with self._completions_lock:
            self._trim(now)
            if not self._completions:
                return 0.0
            total = sum(n for _, n in self._completions)
            span = max(now - self._completions[0][0], 1e-9)
            # a single just-landed batch would divide by ~0; floor the span
            # at 1s so the gauge ramps instead of spiking
            return total / max(span, 1.0)

    # ------------------------------------------------------------------
    def render_prometheus(self) -> str:
        doc = PromText(_PREFIX)
        counter, gauge = doc.counter, doc.gauge

        doc.header("requests_total", "Requests by HTTP status", "counter")
        with self._requests_lock:
            items = sorted((k, c.value) for k, c in
                           self.requests_total.items())
        for status, value in items:
            doc.sample("requests_total", f'{{status="{status}"}}', value)
        counter("accepted_total", "Requests offered to the micro-batcher "
                "(books: accepted == cache_hit + scored + shed + deadline "
                "+ failed)", self.accepted_total.value)
        counter("scored_total", "Requests resolved with a score",
                self.scored_total.value)
        counter("failed_total", "Requests resolved with an error (engine "
                "fault, non-finite batch, stall, shutdown)",
                self.failed_total.value)
        counter("shed_total", "Requests rejected 429 (queue full)",
                self.shed_total.value)
        counter("deadline_total", "Requests failed 504 (deadline exceeded)",
                self.deadline_total.value)
        counter("batches_total", "Device batches executed",
                self.batches_total.value)
        counter("batch_rows_total", "Real rows across executed batches",
                self.batch_rows_total.value)
        counter("padded_rows_total", "Padding rows across executed batches",
                self.padded_rows_total.value)
        counter("compiles_total", "Bucket programs readied by the engine: "
                "CUDA graph captures on the card, eager programs on the CPU "
                "(warmup and live model adds only)",
                self.compiles_total.value)
        counter("backend_compiles_total", "CUDA graph captures observed "
                "process-wide (growth after ready=1 means something "
                "recaptured)", capture_count())
        counter("reloads_total", "Successful hot weight reloads",
                self.reloads_total.value)
        counter("reload_errors_total", "Rejected/failed hot reloads",
                self.reload_errors_total.value)
        counter("reload_canary_failures_total", "Hot reloads rejected by "
                "the golden-batch canary (non-finite / drifted scores)",
                self.reload_canary_failures_total.value)
        counter("worker_restarts_total", "Engine worker crash recoveries",
                self.worker_restarts_total.value)
        counter("watchdog_recoveries_total", "Watchdog-driven engine "
                "restarts (stuck batch or dead worker)",
                self.watchdog_recoveries_total.value)
        counter("nonfinite_batches_total", "Device batches discarded for "
                "NaN/Inf scores (every row failed 503, never served)",
                self.nonfinite_batches_total.value)
        counter("rewarms_total", "Full bucket re-warm passes after a "
                "recovery (replays existing programs; no recaptures)",
                self.rewarms_total.value)
        counter("breaker_opens_total", "Circuit-breaker closed/half-open "
                "-> open transitions", self.breaker_opens_total.value)
        counter("breaker_probes_total", "Half-open probe requests admitted",
                self.breaker_probes_total.value)
        counter("breaker_rejected_total", "Requests shed 503 by the open "
                "breaker", self.breaker_rejected_total.value)
        counter("cache_hit_total", "Requests resolved by the verdict "
                "cache — exact + near-dup + coalesced (books: accepted "
                "== cache_hit + scored + shed + deadline + failed)",
                self.cache_hit_total.value)
        counter("cache_near_hit_total", "Verdict-cache hits via the "
                "near-dup perceptual index (subset of cache_hit_total; "
                "never conflated with exact hits)",
                self.cache_near_hit_total.value)
        counter("cache_coalesced_total", "Requests that rode an "
                "in-flight twin's single dispatch (subset of "
                "cache_hit_total)", self.cache_coalesced_total.value)
        counter("cache_miss_total", "Keyed submits that found no cached "
                "verdict and dispatched", self.cache_miss_total.value)
        counter("cache_insert_total", "Verdicts stored after a scored "
                "miss", self.cache_insert_total.value)
        counter("cache_expired_total", "Verdict-cache entries dropped at "
                "TTL expiry", self.cache_expired_total.value)
        counter("cache_evicted_total", "Verdict-cache entries evicted by "
                "LRU capacity", self.cache_evicted_total.value)
        counter("cache_invalidated_total", "Verdict-cache entries purged "
                "by a reload's fingerprint bump (stale hits are "
                "impossible by construction; this reclaims the memory)",
                self.cache_invalidated_total.value)
        counter("warmstart_hits_total", "Warm-start store entries "
                "deserialized at warmup (each still gated by the "
                "golden-batch canary before serving)",
                self.warmstart_hits_total.value)
        counter("warmstart_misses_total", "Warm-start store lookups "
                "that found no entry (fresh compile + serialize)",
                self.warmstart_misses_total.value)
        counter("warmstart_fallbacks_total", "Warm-start entries "
                "present but unusable (corrupt/foreign/version-skew) — "
                "counted fallback to fresh compile, never a crash",
                self.warmstart_fallbacks_total.value)
        counter("warmstart_canary_rejects_total", "Deserialized "
                "executables rejected by the golden-batch canary "
                "(non-finite/shape/bit-drift) and recompiled fresh",
                self.warmstart_canary_rejects_total.value)
        counter("warmstart_serialized_total", "Executables serialized "
                "into the warm-start store this process",
                self.warmstart_serialized_total.value)
        # per-model request books (multi-model engine): one labeled
        # family per resolution kind, mirroring the global ledger
        with self._model_lock:
            model_items = sorted(
                ((kind, model), c.value)
                for (kind, model), c in self.model_books.items())
        for kind in MODEL_BOOK_KINDS:
            doc.header(f"model_{kind}_total",
                       f"Per-model request books: {kind}", "counter")
            for (k, model), value in model_items:
                if k == kind:
                    doc.sample(f"model_{kind}_total",
                               f'{{model="{model}"}}', value)
        doc.header("bucket_rows_total", "Rows per executed (model, "
                   "bucket) batch, split real|pad (the per-bucket "
                   "padding report)", "counter")
        with self._bucket_lock:
            bucket_items = sorted((k, c.value)
                                  for k, c in self.bucket_rows.items())
        for (model, bucket, kind), value in bucket_items:
            doc.sample("bucket_rows_total",
                       f'{{model="{model}",bucket="{bucket}",'
                       f'kind="{kind}"}}', value)
        counter("cascade_triaged_total", "Clips scored by the cascade "
                "student (books: triaged == cleared + escalated)",
                self.cascade_triaged_total.value)
        counter("cascade_cleared_total", "Cascade clips resolved by the "
                "student verdict (score outside the suspect band)",
                self.cascade_cleared_total.value)
        counter("cascade_escalated_total", "Cascade clips escalated to "
                "the flagship (books: escalated == flagship_scored + "
                "escalation_failed)", self.cascade_escalated_total.value)
        counter("cascade_flagship_scored_total", "Escalated clips "
                "resolved by a flagship score",
                self.cascade_flagship_scored_total.value)
        counter("cascade_escalation_failed_total", "Escalations that "
                "failed (shed/deadline/engine fault): the student "
                "verdict is served instead — never a silent drop",
                self.cascade_escalation_failed_total.value)
        doc.header("chaos_injections_total",
                   "Injected faults fired (DFD_CHAOS), by point", "counter")
        with self._chaos_lock:
            chaos_items = sorted((k, c.value) for k, c in
                                 self.chaos_injections_total.items())
        for point, value in chaos_items:
            doc.sample("chaos_injections_total", f'{{point="{point}"}}',
                       value)
        gauge("queue_depth", "Requests waiting in the micro-batch queue",
              self.queue_depth)
        gauge("cache_entries", "Verdicts currently stored in the cache",
              self.cache_entries)
        gauge("inflight", "Requests staged on device", self.inflight)
        gauge("ready", "1 once all buckets are warmed (drops during "
              "recovery re-warm and the reload canary)", int(self.ready))
        gauge("breaker_state", "Circuit breaker state (0 closed, 1 open, "
              "2 half-open)", self.breaker_state)
        gauge("throughput_rps",
              f"Scored requests/sec, trailing {self._window_s:.0f}s window",
              round(self.throughput(), 3))
        doc.header("warmup_seconds", "Cold-start stage walls "
                   "(spawn -> serving), seconds", "gauge")
        for stage in WARMUP_STAGES:
            doc.sample("warmup_seconds", f'{{stage="{stage}"}}',
                       round(self.warmup_seconds[stage], 6))

        for stage in STAGES:
            # one-snapshot consistency per stage lives in PromText.histogram
            doc.histogram("latency_seconds", "Per-stage request latency",
                          self.latency[stage], labels=f'stage="{stage}"')
        for tier in CASCADE_TIERS:
            doc.histogram("cascade_latency_seconds",
                          "Per-tier cascade latency (submit -> verdict)",
                          self.cascade_latency[tier],
                          labels=f'tier="{tier}"')
        return doc.render()
