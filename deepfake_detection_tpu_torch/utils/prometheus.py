"""Prometheus text-exposition rendering.

A copy of ``deepfake_detection_tpu/utils/prometheus.py`` (stdlib only), so
that the port's ``GET /metrics`` renders byte for byte what the JAX
package's does.  No prometheus_client dependency, just the text format
(https://prometheus.io/docs/instrumenting/exposition_formats/).

:class:`PromText` is a line accumulator: callers append counter/gauge/
histogram families in catalog order and :meth:`render` joins them
(HELP/TYPE re-emitted per histogram label set, ``le`` bounds formatted
with ``repr``).
"""

from __future__ import annotations

import bisect
import threading
from typing import List, Sequence, Tuple

__all__ = ["Counter", "LatencyHistogram", "PromText"]


class Counter:
    """Monotonic counter; int ops under the GIL are atomic enough, the lock
    is for the read-modify-write of labeled maps."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class LatencyHistogram:
    """Thread-safe fixed-bucket latency histogram (host side, stdlib only).

    The serving-path companion to ``utils.metrics.AverageMeter``: where
    the meter tracks a running average inside the train loop, the
    histogram tracks the full latency distribution of a long-lived server
    (:class:`PromText` renders it in Prometheus ``histogram`` text
    format, so the bucket layout is cumulative-``le`` by construction).

    ``utils.metrics.LatencyHistogram`` is a re-export of this class.

    Buckets are upper bounds in seconds; observations above the last bound
    land in the implicit ``+Inf`` bucket.
    """

    #: default bounds: 1 ms .. 30 s, roughly log-spaced (Prometheus idiom)
    DEFAULT_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                      0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in bounds))
        if not self.bounds:
            raise ValueError("LatencyHistogram needs at least one bound")
        self._counts = [0] * (len(self.bounds) + 1)   # [+Inf] is last
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        i = bisect.bisect_left(self.bounds, seconds)
        with self._lock:
            self._counts[i] += 1
            self.sum += seconds
            self.count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. +Inf, sum, count) — one consistent view."""
        with self._lock:
            return list(self._counts), self.sum, self.count

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le_bound, cumulative_count), ...] with +Inf last (le=inf)."""
        counts, _, _ = self.snapshot()
        out, acc = [], 0
        for b, c in zip(self.bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def quantile(self, q: float) -> float:
        """Approximate quantile: upper bound of the bucket holding rank q
        (the resolution any fixed-bucket histogram has; good enough for a
        p50/p95/p99 serving report)."""
        counts, _, total = self.snapshot()
        if total == 0:
            return float("nan")
        rank = q * total
        acc = 0
        for b, c in zip(self.bounds, counts):
            acc += c
            if acc >= rank:
                return b
        return float("inf")

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self.sum = 0.0
            self.count = 0


class PromText:
    """Accumulates one exposition document under a metric-name prefix."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.lines: List[str] = []

    # -- raw pieces (labeled families interleave header and samples) ----
    def header(self, name: str, help_: str, type_: str) -> None:
        self.lines.append(f"# HELP {self.prefix}_{name} {help_}")
        self.lines.append(f"# TYPE {self.prefix}_{name} {type_}")

    def sample(self, name: str, labels: str, value) -> None:
        self.lines.append(f"{self.prefix}_{name}{labels} {value}")

    # -- one-shot families ---------------------------------------------
    def counter(self, name: str, help_: str, value, labels: str = "") -> None:
        self.header(name, help_, "counter")
        self.sample(name, labels, value)

    def gauge(self, name: str, help_: str, value) -> None:
        self.header(name, help_, "gauge")
        self.sample(name, "", value)

    def histogram(self, name: str, help_, hist, labels: str = "") -> None:
        """One ``histogram`` family block from a LatencyHistogram.

        ``labels`` is the pre-formatted inner label list (e.g.
        ``'stage="queue"'``).  Buckets, sum and count come from ONE
        snapshot: mixing live reads could make the +Inf bucket exceed
        ``_count`` within a single exposition (spec violation that breaks
        ``histogram_quantile`` exactly under load).
        """
        full = f"{self.prefix}_{name}"
        self.lines.append(f"# HELP {full} {help_}")
        self.lines.append(f"# TYPE {full} histogram")
        counts, s, c = hist.snapshot()
        pre = f"{labels}," if labels else ""
        acc = 0
        for bound, n in zip(hist.bounds, counts):
            acc += n
            self.lines.append(f'{full}_bucket{{{pre}le="{bound!r}"}} {acc}')
        self.lines.append(f'{full}_bucket{{{pre}le="+Inf"}} {c}')
        self.lines.append(f'{full}_sum{{{labels}}} {s}')
        self.lines.append(f'{full}_count{{{labels}}} {c}')

    # ------------------------------------------------------------------
    def render(self) -> str:
        return "\n".join(self.lines) + "\n"
