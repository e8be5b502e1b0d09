"""Serving resilience primitives: typed failures, circuit breaker, stuck-
batch watchdog, retry jitter.

A copy of ``deepfake_detection_tpu/serving/resilience.py``.  The pieces
are deliberately small state machines that know nothing of the device,
so the tests can drive every transition with an injected clock, while
``serving/engine.py`` wires them to the real device loop.

Failure taxonomy (what an HTTP client sees):

* :class:`NonFiniteScores` — the device batch executed but produced
  NaN/Inf rows.  Mapped to **503** (+ Retry-After): the *request* was
  fine, the *serving set* is suspect — a silent NaN score would poison
  every downstream verdict, so it is never returned.
* :class:`EngineStalled` — the stuck-batch watchdog abandoned a device
  batch that never completed.  Mapped to **503**; readiness drops until
  the engine worker is restarted and every bucket program is re-warmed.
* :class:`BreakerOpen` — the circuit breaker is rejecting before the
  queue: **503** + jittered Retry-After without touching the batcher.

The breaker follows the classic three-state contract (all state visible
in ``/metrics``):

* **closed** — normal serving; ``failure_threshold`` *consecutive* batch
  failures open it (successes reset the streak — sporadic poison
  requests must not trip it).
* **open** — every ``allow()`` is rejected for ``open_s`` seconds with a
  Retry-After derived from the remaining cooldown plus a bounded jitter
  (the bare remainder would point every shed client at the same
  half-open instant).
* **half-open** — after the cooldown exactly ONE probe is admitted; its
  batch outcome closes the breaker (success) or re-opens it (failure).
  Other arrivals keep shedding while the probe is in flight.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Optional

__all__ = ["NonFiniteScores", "EngineStalled", "BreakerOpen",
           "CircuitBreaker", "ServeWatchdog", "jittered_retry_after",
           "torn_copy", "BREAKER_CLOSED", "BREAKER_OPEN",
           "BREAKER_HALF_OPEN"]


class NonFiniteScores(RuntimeError):
    """The device batch returned NaN/Inf scores (never served silently)."""


class EngineStalled(RuntimeError):
    """A device batch exceeded the stuck-batch watchdog timeout."""


class BreakerOpen(RuntimeError):
    """The circuit breaker is open; retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"circuit breaker open; retry in "
                         f"{retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


def jittered_retry_after(base_s: float, spread_s: float,
                         rng: Optional[random.Random] = None) -> float:
    """``base_s`` plus a bounded uniform spread.

    A constant Retry-After synchronizes every shed client into one
    thundering-herd resend wave exactly ``base_s`` later; the uniform
    ``[0, spread_s)`` jitter de-correlates them while keeping the bound
    explicit (the advertised worst case is ``base_s + spread_s``)."""
    r = rng if rng is not None else random
    return float(base_s) + r.uniform(0.0, max(0.0, float(spread_s)))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

#: stable numeric encoding for the /metrics gauge
BREAKER_STATE_CODE = {BREAKER_CLOSED: 0, BREAKER_OPEN: 1,
                      BREAKER_HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker over *batch* outcomes.

    ``allow()`` gates admission (HTTP thread), ``record_success`` /
    ``record_failure`` report batch outcomes (engine thread).  A
    ``failure_threshold`` of 0 disables the breaker entirely (``allow``
    always True, outcomes ignored) so the knob can be turned off without
    a second code path at the call sites.

    ``clock`` is injectable for deterministic state-machine tests.
    """

    def __init__(self, failure_threshold: int = 5, open_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None, retry_jitter_s: float = 2.0):
        self.failure_threshold = int(failure_threshold)
        self.open_s = float(open_s)
        self.retry_jitter_s = float(retry_jitter_s)
        self._retry_rng = random.Random(0xB12EA4)
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0

    # ------------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str) -> None:
        self._state = state
        if self._metrics is not None:
            self._metrics.breaker_state = BREAKER_STATE_CODE[state]

    # ------------------------------------------------------------------
    def allow(self) -> None:
        """Admission check; raises :class:`BreakerOpen` when shedding.

        The OPEN → HALF_OPEN transition happens lazily here (no timer
        thread): the first arrival after the cooldown becomes the probe.
        """
        if not self.enabled:
            return
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return
            now = self._clock()
            if self._state == BREAKER_OPEN:
                remaining = self._opened_at + self.open_s - now
                if remaining > 0:
                    if self._metrics is not None:
                        self._metrics.breaker_rejected_total.inc()
                    # jittered: the remaining cooldown alone would point
                    # every shed client at the same half-open instant —
                    # one resend wave, one probe, everyone else shed again
                    raise BreakerOpen(jittered_retry_after(
                        max(0.1, remaining), self.retry_jitter_s,
                        self._retry_rng))
                self._set_state(BREAKER_HALF_OPEN)
                self._probe_inflight = False
            # HALF_OPEN: exactly one probe rides through.  A probe whose
            # outcome never reports (e.g. its request deadlined out of
            # the queue) must not wedge the breaker shut — after a full
            # cooldown's worth of silence the next arrival re-probes.
            if self._probe_inflight and \
                    now - self._probe_started <= self.open_s:
                if self._metrics is not None:
                    self._metrics.breaker_rejected_total.inc()
                raise BreakerOpen(jittered_retry_after(
                    max(0.1, self.open_s / 2.0), self.retry_jitter_s,
                    self._retry_rng))
            self._probe_inflight = True
            self._probe_started = now
            if self._metrics is not None:
                self._metrics.breaker_probes_total.inc()

    # ------------------------------------------------------------------
    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._consecutive_failures = 0
            if self._state != BREAKER_CLOSED:
                self._set_state(BREAKER_CLOSED)
                self._probe_inflight = False

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._state == BREAKER_HALF_OPEN:
                # the probe failed: back to a full cooldown
                self._opened_at = self._clock()
                self._set_state(BREAKER_OPEN)
                self._probe_inflight = False
                self._consecutive_failures = self.failure_threshold
                if self._metrics is not None:
                    self._metrics.breaker_opens_total.inc()
                return
            self._consecutive_failures += 1
            if self._state == BREAKER_CLOSED and \
                    self._consecutive_failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._set_state(BREAKER_OPEN)
                if self._metrics is not None:
                    self._metrics.breaker_opens_total.inc()


# ---------------------------------------------------------------------------
# stuck-batch watchdog
# ---------------------------------------------------------------------------

class ServeWatchdog:
    """Monitor thread for the engine's two wedge modes: a device batch
    that never completes (hang) and a worker thread that died outright
    (an injected kill, an un-catchable error).

    Deliberately knows nothing about the device: it reads two callables —
    ``oldest_dispatch()`` (monotonic dispatch time of the oldest
    in-flight batch, or None) and ``worker_alive()`` — and calls
    ``recover(reason)`` on the watchdog thread when either trips.
    ``recover`` runs synchronously, so a recovery that re-warms every
    bucket cannot be re-triggered mid-flight.
    """

    def __init__(self, timeout_s: float,
                 oldest_dispatch: Callable[[], Optional[float]],
                 worker_alive: Callable[[], bool],
                 recover: Callable[[str], None],
                 poll_s: float = 0.05):
        self.timeout_s = float(timeout_s)
        self._oldest_dispatch = oldest_dispatch
        self._worker_alive = worker_alive
        self._recover = recover
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            oldest = self._oldest_dispatch()
            if oldest is not None and \
                    time.monotonic() - oldest > self.timeout_s:
                self._recover("stalled")
                continue
            if not self._worker_alive():
                self._recover("worker_died")


# ---------------------------------------------------------------------------
# chaos support
# ---------------------------------------------------------------------------

def torn_copy(path: str, tmp_dir: Optional[str] = None) -> str:
    """Write a half-truncated copy of ``path`` next to it (or in
    ``tmp_dir``) and return the copy's path.

    The ``torn_reload`` chaos point routes the reload watcher through
    this so the REAL torn-file rejection path (the loader's own error
    naming the file) is exercised, not a synthetic stand-in."""
    with open(path, "rb") as f:
        data = f.read()
    dst = os.path.join(tmp_dir or os.path.dirname(path),
                       ".chaos-torn-" + os.path.basename(path))
    with open(dst, "wb") as f:
        f.write(data[:max(1, len(data) // 2)])
    return dst
