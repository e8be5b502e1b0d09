"""Streaming observability: the ``dfd_streaming_*`` Prometheus catalog.

Counterpart of ``deepfake_detection_tpu/streaming/metrics.py``: the same
metric names.

Same construction as ``serving/metrics.py`` (stdlib counters +
:class:`LatencyHistogram`, rendered through the shared
``utils/prometheus.py`` text renderer); the streaming front end serves
this catalog concatenated after the serving one on ``GET /metrics``, so
one scrape sees the whole pipeline: HTTP ingest → decode → track →
window → micro-batcher → device.

Stage histograms follow a frame/window's life:

* ``decode`` — chunk bytes → uint8 frames (raw wire, JPEG, or Pillow);
* ``track`` — localize + tracker update + crop + canvas per frame;
* ``assemble`` — window emission → job dispatched (key + payload);
* ``score`` — window queued → softmax row back (queue + device);
* ``ingest`` — whole ``POST /streams/<id>/frames`` handler.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..utils.prometheus import Counter as _Counter
from ..utils.prometheus import LatencyHistogram
from ..utils.prometheus import PromText

__all__ = ["StreamingMetrics", "STAGES"]

_PREFIX = "dfd_streaming"

#: same sub-ms-resolving bounds as serving — ingest stages are host work
_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

STAGES = ("decode", "track", "assemble", "score", "ingest")


class StreamingMetrics:
    """One registry per streaming server process."""

    def __init__(self):
        self.latency: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram(_BOUNDS) for s in STAGES}
        self.streams_opened_total = _Counter()
        self.streams_closed_total = _Counter()
        self.streams_evicted_total = _Counter()
        self.frames_ingested_total = _Counter()
        self.frames_decode_errors_total = _Counter()
        self.chunks_total = _Counter()
        self.tracks_born_total = _Counter()
        self.tracks_died_total = _Counter()
        self.windows_emitted_total = _Counter()
        self.windows_scored_total = _Counter()
        self.windows_dropped_total = _Counter()    # drop-oldest backpressure
        self.windows_shed_total = _Counter()       # batcher QueueFull
        self.windows_failed_total = _Counter()     # deadline / engine error
        self.windows_cache_hit_total = _Counter()  # resolved from the
        # verdict cache (content-identical clip scored before) — never
        # entered a device bucket
        self.windows_dup_elided_total = _Counter()  # clip content identical
        # to the track's previous window (dedup_frames): submission skipped
        self.frames_dup_elided_total = _Counter()  # encoded bytes identical
        # to the previous frame (dedup_frames): decode skipped
        self.canvas_copies_elided_total = _Counter()  # redundant host
        # staging work skipped (already-contiguous crops; duplicate-frame
        # canvas reuse under dedup_frames)
        self.ring_overflow_total = _Counter()      # crop-ring pool
        # exhausted: counted standalone-row fallback (never a stall)
        self.demux_failures_total = _Counter()     # ffmpeg died mid-stream
        self.streams_restored_total = _Counter()   # sessions resumed from
        # a state-dir snapshot after a server bounce
        self.streams_migrated_out_total = _Counter()   # sessions exported
        # to another replica (fleet drain)
        self.streams_migrated_in_total = _Counter()    # sessions restored
        # FROM another replica via POST /streams/restore
        self.state_errors_total = _Counter()       # snapshot save/restore
        # failures (corrupt/stale state files, unwritable dir)
        self.verdict_transitions_total: Dict[str, _Counter] = {}
        self._verdict_lock = threading.Lock()
        self.active_streams = 0                    # gauge (manager-owned)
        self.active_tracks = 0                     # gauge (manager-owned)

    # ------------------------------------------------------------------
    def count_transition(self, to_state: str) -> None:
        with self._verdict_lock:
            c = self.verdict_transitions_total.get(to_state)
            if c is None:
                c = self.verdict_transitions_total[to_state] = _Counter()
        c.inc()

    # ------------------------------------------------------------------
    def render_prometheus(self) -> str:
        doc = PromText(_PREFIX)
        counter, gauge = doc.counter, doc.gauge
        counter("streams_opened_total", "Stream sessions created",
                self.streams_opened_total.value)
        counter("streams_closed_total", "Stream sessions closed by clients",
                self.streams_closed_total.value)
        counter("streams_evicted_total", "Stream sessions evicted idle "
                "(TTL)", self.streams_evicted_total.value)
        counter("chunks_total", "Frame chunks accepted over HTTP",
                self.chunks_total.value)
        counter("frames_ingested_total", "Frames decoded into the pipeline",
                self.frames_ingested_total.value)
        counter("frames_decode_errors_total", "Frames dropped undecodable",
                self.frames_decode_errors_total.value)
        counter("tracks_born_total", "Face tracks born",
                self.tracks_born_total.value)
        counter("tracks_died_total", "Face tracks retired (coast budget "
                "exhausted)", self.tracks_died_total.value)
        counter("windows_emitted_total", "Temporal windows emitted by the "
                "windower", self.windows_emitted_total.value)
        counter("windows_scored_total", "Windows scored by the engine",
                self.windows_scored_total.value)
        counter("windows_dropped_total", "Windows dropped by per-stream "
                "drop-oldest backpressure or stream close",
                self.windows_dropped_total.value)
        counter("windows_shed_total", "Windows shed by the micro-batcher "
                "(queue full)", self.windows_shed_total.value)
        counter("windows_failed_total", "Windows failed (deadline or "
                "engine error)", self.windows_failed_total.value)
        counter("windows_cache_hit_total", "Windows resolved from the "
                "verdict cache (never entered a bucket)",
                self.windows_cache_hit_total.value)
        counter("windows_dup_elided_total", "Windows skipped as exact "
                "duplicates of the track's previous window",
                self.windows_dup_elided_total.value)
        counter("frames_dup_elided_total", "Frames whose decode was "
                "skipped as byte-identical to their predecessor",
                self.frames_dup_elided_total.value)
        counter("canvas_copies_elided_total", "Redundant host canvas "
                "staging skipped (contiguous crops, duplicate-frame "
                "reuse)", self.canvas_copies_elided_total.value)
        counter("ring_overflow_total", "Crop-ring pool exhaustions "
                "(counted standalone-row fallback)",
                self.ring_overflow_total.value)
        counter("demux_failures_total", "ffmpeg demuxer deaths surfaced "
                "as per-stream errors (422 + demuxer reset)",
                self.demux_failures_total.value)
        counter("streams_restored_total", "Stream sessions resumed from "
                "a state-dir snapshot", self.streams_restored_total.value)
        counter("streams_migrated_out_total", "Stream sessions exported "
                "to another replica (fleet drain: quiesce -> snapshot "
                "-> detach)", self.streams_migrated_out_total.value)
        counter("streams_migrated_in_total", "Stream sessions restored "
                "from another replica's snapshot (POST /streams/restore)",
                self.streams_migrated_in_total.value)
        counter("state_errors_total", "Session snapshot save/restore "
                "failures (corrupt or unwritable state files)",
                self.state_errors_total.value)
        doc.header("verdict_transitions_total",
                   "Verdict state transitions by destination state",
                   "counter")
        with self._verdict_lock:
            items = sorted((k, c.value) for k, c in
                           self.verdict_transitions_total.items())
        for state, value in items:
            doc.sample("verdict_transitions_total", f'{{to="{state}"}}',
                       value)
        gauge("active_streams", "Live stream sessions",
              self.active_streams)
        gauge("active_tracks", "Live face tracks across all streams",
              self.active_tracks)
        for stage in STAGES:
            doc.histogram("latency_seconds", "Per-stage streaming latency",
                          self.latency[stage], labels=f'stage="{stage}"')
        return doc.render()
