"""Two-tier scoring cascade: a small student triages every clip, only
suspects pay for the flagship.

A copy of ``deepfake_detection_tpu/serving/cascade.py``.

The req/s-per-chip lever on real traffic mixes: most clips are obviously
clean (or obviously fake) and a model a fraction of the flagship's size
clears them with the same verdict.  The router scores EVERY clip on the
student first; a fake-probability inside the configurable **suspect
band** ``[low, high]`` escalates the clip to the flagship, anything
outside the band returns the student verdict directly.  Both tiers ride
the SAME engine/batcher/buckets, so the engine's invariants (programs
made only at warmup, exact request books, breaker/watchdog recovery)
apply to cascade traffic unchanged.

Books — both identities hold EXACTLY through every fault, audited from
/metrics by the cascade tests::

    cascade_triaged   == cascade_cleared + cascade_escalated
    cascade_escalated == cascade_flagship_scored + cascade_escalation_failed

Failure semantics: a *student*-phase failure (shed, deadline, engine
fault) propagates to the client exactly like a single-model request —
the clip was never triaged.  A *flagship*-phase failure serves the
student verdict instead, counted in ``cascade_escalation_failed_total``
— an escalation failure is NEVER a silent drop, and never an error for
a clip the student already scored.

Per-tier latency rides ``dfd_serving_cascade_latency_seconds{tier=}``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from .metrics import ServingMetrics

__all__ = ["CascadeResult", "CascadeRouter", "DeadlineExhausted"]


class DeadlineExhausted(RuntimeError):
    """The shared cascade budget was spent before the flagship leg could
    start — handled as an escalation failure (student verdict served)."""


class CascadeResult:
    """Outcome of one cascade scoring: the served scores plus the triage
    trail (which tier answered, the student's fake score, whether an
    escalation happened/failed)."""

    __slots__ = ("scores", "tier", "student_score", "escalated",
                 "escalation_error", "timings")

    def __init__(self, scores: Any, tier: str, student_score: float,
                 escalated: bool,
                 escalation_error: Optional[str] = None,
                 timings: Optional[dict] = None):
        self.scores = scores
        self.tier = tier                   # "student" | "flagship"
        self.student_score = student_score
        self.escalated = escalated
        self.escalation_error = escalation_error
        # queue/device timings of the request whose verdict was SERVED
        # (the student's when tier == "student") — the HTTP layer reports
        # these instead of zeros for cascade traffic
        self.timings = timings if timings is not None else {}


class CascadeRouter:
    """Student-first routing over one micro-batcher.

    ``batcher`` only needs ``submit(array, timeout_s=..., model_id=...)``
    returning an object with ``result(timeout=...)`` — the real
    :class:`~.batcher.MicroBatcher` in production, a stub in the
    fault-sequencing unit tests.
    """

    def __init__(self, batcher, metrics: ServingMetrics, *,
                 student_id: str, flagship_id: str,
                 low: float, high: float, timeout_s: float = 2.0):
        if not 0.0 <= float(low) <= float(high) <= 1.0:
            raise ValueError(f"suspect band must satisfy 0 <= low <= "
                             f"high <= 1, got [{low}, {high}]")
        if student_id == flagship_id:
            raise ValueError("cascade student and flagship must be "
                             "different models")
        self.batcher = batcher
        self.metrics = metrics
        self.student_id = student_id
        self.flagship_id = flagship_id
        self.low = float(low)
        self.high = float(high)
        self.timeout_s = float(timeout_s)

    # ------------------------------------------------------------------
    def suspect(self, p_fake: float) -> bool:
        """True iff the student's fake score falls in the suspect band."""
        return self.low <= p_fake <= self.high

    def score(self, student_payload: Any,
              flagship_payload: Callable[[], Any],
              content_key: Optional[Any] = None) -> CascadeResult:
        """Triage one clip.

        ``flagship_payload`` is a thunk so the (possibly larger) flagship
        canvas is only prepared for the escalated fraction.  Student-
        phase exceptions propagate; flagship-phase exceptions degrade to
        the student verdict (counted).

        ``content_key`` is the clip's verdict-cache identity,
        forwarded to BOTH tier submits — the cache key carries the model
        id, so student and flagship verdicts never mix, and the tiers
        compose multiplicatively: cache → student → flagship.

        The two tiers share ONE ``timeout_s`` budget: the flagship leg
        gets whatever the student left (an exhausted budget at escalation
        time is a flagship-phase failure → student verdict + counter),
        so an escalated request can never take ~2× the configured
        deadline behind a 200."""
        m = self.metrics
        t0 = time.monotonic()
        kw = {} if content_key is None else {"content_key": content_key}
        req = self.batcher.submit(student_payload,
                                  timeout_s=self.timeout_s,
                                  model_id=self.student_id, **kw)
        # raises on shed/deadline/fault: the clip was never triaged, and
        # the per-model books already account the failed student request
        s_scores = req.result(timeout=self.timeout_s + 5.0)
        # timings are optional on the batcher contract (stubs omit them)
        s_timings = dict(getattr(req, "timings", {}))
        m.cascade_latency["student"].observe(time.monotonic() - t0)
        m.cascade_triaged_total.inc()
        p_fake = float(s_scores[0])
        if not self.suspect(p_fake):
            m.cascade_cleared_total.inc()
            return CascadeResult(s_scores, "student", p_fake,
                                 escalated=False, timings=s_timings)
        m.cascade_escalated_total.inc()
        t1 = time.monotonic()
        remaining = self.timeout_s - (t1 - t0)
        try:
            if remaining <= 0:
                raise DeadlineExhausted(
                    f"cascade budget {self.timeout_s:.3f}s spent in the "
                    f"student phase")
            freq = self.batcher.submit(flagship_payload(),
                                       timeout_s=remaining,
                                       model_id=self.flagship_id, **kw)
            f_scores = freq.result(timeout=remaining + 5.0)
        except Exception as e:                     # noqa: BLE001
            # the student verdict is still a verdict: serve it, count the
            # failed escalation — never a silent drop, never a client
            # error for a clip the student already scored
            m.cascade_escalation_failed_total.inc()
            return CascadeResult(s_scores, "student", p_fake,
                                 escalated=True,
                                 escalation_error=repr(e),
                                 timings=s_timings)
        m.cascade_latency["flagship"].observe(time.monotonic() - t1)
        m.cascade_flagship_scored_total.inc()
        return CascadeResult(f_scores, "flagship", p_fake, escalated=True,
                             timings=dict(getattr(freq, "timings", {})))
