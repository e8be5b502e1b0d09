"""Temporal sliding-window batcher: per-track crops → flagship-shaped
clips → serving-engine buckets.

Counterpart of ``deepfake_detection_tpu/streaming/windows.py``.

The 12-channel flagship scores ``img_num`` *distinct* frames channel-
concatenated into one clip; a live track delivers one crop per frame.
This module closes the gap:

* :class:`TrackWindower` buffers the last crops of each track and emits a
  window of ``img_num`` frames every ``hop`` pushes, taking every
  ``stride``-th frame so a window can span more wall time than
  ``img_num`` consecutive frames.  ``hop < img_num·stride`` overlaps
  windows (denser verdicts), ``hop == img_num·stride`` tiles them.
* :func:`build_payload` turns a window's uint8 canvases into the serving
  wire format: the float32 wire runs the exact CLI preprocess
  (``params.normalize_concat``) host-side, so a window's score is
  bit-identical to scoring the same clip through ``runners/test.py``;
  the uint8 wire ships channel-concatenated uint8 and normalizes inside
  the engine's multi-frame program.
* :class:`WindowDispatcher` feeds windows into the serving micro-batcher
  under **bounded per-stream queues with drop-oldest backpressure**: a
  slow device must shed the *stalest* windows (their verdict value decays
  fastest) while frames keep flowing — an unbounded queue would instead
  grow a backlog whose scores arrive too late to matter.  Batcher-level
  load shedding (``QueueFull``) and per-request deadlines are counted,
  never silent.

One dispatcher (2 threads) serves every stream in the process: a submit
thread drains the per-stream deques round-robin (no stream can starve
another), and a collector thread blocks on results in submission order —
the engine completes batches FIFO, so head-of-line blocking here is
bounded by one request deadline.
"""

from __future__ import annotations

import base64
import collections
import logging
import queue
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from . import ring as ring_mod

__all__ = ["Window", "TrackWindower", "build_payload", "WindowJob",
           "WindowDispatcher"]

_logger = logging.getLogger(__name__)


class Window:
    """One emitted clip: ``img_num`` uint8 canvases + their frame indices.

    On the frame-once path the frames are views into the
    per-track :class:`~.ring.CanvasRing`; ``digests`` carries the cached
    per-crop sha256s (frame order) for window content keys, and ``refs``
    the ring pins this window took at emission — whoever consumes the
    window releases them (the session wraps them in a ``RingLease``).
    """

    __slots__ = ("track_id", "frames", "frame_idxs", "window_idx",
                 "digests", "refs")

    def __init__(self, track_id: int, frames: List[np.ndarray],
                 frame_idxs: Tuple[int, ...], window_idx: int,
                 digests: Optional[Tuple[bytes, ...]] = None,
                 refs: Optional[List[Any]] = None):
        self.track_id = track_id
        self.frames = frames
        self.frame_idxs = frame_idxs
        self.window_idx = window_idx
        self.digests = digests
        self.refs = refs


class TrackWindower:
    """Per-track sliding windows of ``img_num`` distinct frames.

    ``stride`` is the in-window frame spacing (1 = consecutive crops);
    ``hop`` is how many pushes separate consecutive emissions (default
    ``img_num * stride``: non-overlapping tiling).  Window ``k`` holds the
    newest crop plus the ``img_num - 1`` crops ``stride`` pushes apart
    behind it, oldest first — the channel order ``MultiConcate`` gives
    training clips.
    """

    def __init__(self, img_num: int, stride: int = 1, hop: int = 0,
                 digest_frames: bool = False):
        if img_num < 1:
            raise ValueError(f"img_num must be >= 1, got {img_num}")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.img_num = int(img_num)
        self.stride = int(stride)
        self.hop = int(hop) if hop else self.img_num * self.stride
        if self.hop < 1:
            raise ValueError(f"hop must be >= 1, got {self.hop}")
        self.span = (self.img_num - 1) * self.stride + 1
        # frame-once mode: restored snapshot frames get their canonical
        # digest computed once here, so post-restore windows stay keyable
        self.digest_frames = bool(digest_frames)
        # entries: (frame_idx, canvas, digest|None, FrameRef|None)
        self._buffers: Dict[int, Deque[Tuple[int, np.ndarray,
                                             Optional[bytes], Any]]] = {}
        self._pushes: Dict[int, int] = {}
        self._emitted: Dict[int, int] = {}
        self._last_emit_push: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def push(self, track_id: int, frame_idx: int, canvas: np.ndarray,
             digest: Optional[bytes] = None,
             ref: Any = None) -> Optional[Window]:
        """Add one crop; returns a :class:`Window` when one is due.

        ``digest``/``ref`` ride along on the frame-once path: the buffer
        takes ownership of one reference on ``ref`` and releases it when
        the entry falls out of the span (or the track drops)."""
        buf = self._buffers.get(track_id)
        if buf is None:
            buf = self._buffers[track_id] = collections.deque()
            self._pushes[track_id] = 0
            self._emitted[track_id] = 0
        buf.append((int(frame_idx), canvas, digest, ref))
        if len(buf) > self.span:
            old = buf.popleft()
            if old[3] is not None:
                old[3].decref()
        self._pushes[track_id] += 1
        pushes = self._pushes[track_id]
        if len(buf) < self.span:
            return None
        emitted = self._emitted[track_id]
        # first window fires on the push that fills the span; after that,
        # every `hop` pushes
        if emitted and pushes - self._last_emit_push[track_id] < self.hop:
            return None
        self._emitted[track_id] = emitted + 1
        self._last_emit_push[track_id] = pushes
        picked = [buf[i] for i in range(self.span - 1, -1, -self.stride)]
        picked.reverse()                            # oldest → newest
        idxs = tuple(e[0] for e in picked)
        frames = [e[1] for e in picked]
        digests: Optional[Tuple[bytes, ...]] = tuple(
            e[2] for e in picked)
        if any(d is None for d in digests):
            digests = None
        refs = [e[3] for e in picked if e[3] is not None]
        for r in refs:                              # pin rows for the
            r.incref()                              # window's lifetime
        return Window(track_id, frames, idxs, emitted, digests,
                      refs or None)

    def newest(self, track_id: int) -> Optional[Tuple[int, np.ndarray,
                                                      Optional[bytes],
                                                      Any]]:
        """The track's most recent buffer entry (duplicate-frame reuse)."""
        buf = self._buffers.get(track_id)
        return buf[-1] if buf else None

    def drop_track(self, track_id: int) -> None:
        buf = self._buffers.pop(track_id, None)
        if buf:
            for e in buf:
                if e[3] is not None:
                    e[3].decref()
        self._pushes.pop(track_id, None)
        self._emitted.pop(track_id, None)
        self._last_emit_push.pop(track_id, None)

    def buffered_tracks(self) -> List[int]:
        return sorted(self._buffers)

    # ------------------------------------------------------------------
    # durability (streaming session snapshots): window-POSITION state —
    # pushes/emitted/last-emit counters AND the buffered crops (base64
    # raw bytes + shape), so a restored track continues mid-window and
    # emits its next window at exactly the push an unkilled server would
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        tracks = {}
        for tid, buf in self._buffers.items():
            tracks[str(tid)] = {
                "pushes": self._pushes[tid],
                "emitted": self._emitted[tid],
                "last_emit_push": self._last_emit_push.get(tid),
                "frames": [
                    {"frame_idx": fi,
                     "shape": list(np.shape(canvas)),
                     "dtype": str(np.asarray(canvas).dtype),
                     "data_b64": base64.b64encode(
                         np.ascontiguousarray(canvas).tobytes()).decode()}
                    for fi, canvas, _digest, _ref in buf],
            }
        return {"img_num": self.img_num, "stride": self.stride,
                "hop": self.hop, "tracks": tracks}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if (int(d["img_num"]), int(d["stride"]), int(d["hop"])) != \
                (self.img_num, self.stride, self.hop):
            raise ValueError(
                f"windower geometry changed across restart: snapshot has "
                f"img_num={d['img_num']} stride={d['stride']} "
                f"hop={d['hop']}, server runs img_num={self.img_num} "
                f"stride={self.stride} hop={self.hop}")
        for tid in list(self._buffers):
            self.drop_track(tid)                   # release any ring pins
        self._buffers.clear()
        self._pushes.clear()
        self._emitted.clear()
        self._last_emit_push.clear()
        for tid_s, td in d["tracks"].items():
            tid = int(tid_s)
            buf = collections.deque()
            for fr in td["frames"]:
                canvas = np.frombuffer(
                    base64.b64decode(fr["data_b64"]),
                    dtype=np.dtype(fr["dtype"])).reshape(fr["shape"])
                # snapshots predate digests (schema v1 unchanged): the
                # canonical digest is recomputed once at restore so
                # post-restore windows stay cache-keyable
                digest = ring_mod.frame_digest(canvas) \
                    if self.digest_frames else None
                buf.append((int(fr["frame_idx"]), canvas, digest, None))
            self._buffers[tid] = buf
            self._pushes[tid] = int(td["pushes"])
            self._emitted[tid] = int(td["emitted"])
            if td.get("last_emit_push") is not None:
                self._last_emit_push[tid] = int(td["last_emit_push"])


def build_payload(frames: List[np.ndarray], wire: str,
                  on_elide: Optional[Callable[[int], None]] = None
                  ) -> np.ndarray:
    """Window frames (uint8 HWC canvases) → one wire-format sample.

    float32: exact CLI preprocess per frame + channel concat
    (``params.normalize_concat``) — scores are bit-identical to the CLI
    path because the engine's float32 buckets ARE the CLI program.
    uint8: channel-concat only; normalization runs inside the engine's
    multi-frame device program.  ``np.concatenate`` copies its inputs
    regardless of contiguity, so the historical per-frame
    ``ascontiguousarray`` staging copy is elided (counted via
    ``on_elide`` for the frames that would actually have copied —
    non-contiguous crops).
    """
    from ..params import normalize_concat
    if wire == "float32":
        return normalize_concat(frames)
    if on_elide is not None:
        elided = sum(1 for f in frames if not f.flags.c_contiguous)
        if elided:
            on_elide(elided)
    return np.concatenate(frames, axis=-1)


# ---------------------------------------------------------------------------
# Dispatch: bounded per-stream queues → micro-batcher → result collection
# ---------------------------------------------------------------------------

class WindowJob:
    """One window queued for scoring, with enough context for the result
    callback to route it back to its stream/track verdict state.

    ``content_key`` (when the verdict cache is live) is the window's
    ``(content_hash, phash)`` identity for ``MicroBatcher.submit``;
    ``lease`` holds the ring pins released on every terminal path;
    ``cache_hit`` is set by the collector when the request resolved from
    the cache instead of a device bucket."""

    __slots__ = ("stream_id", "track_id", "window_idx", "frame_idxs",
                 "payload", "enqueue_t", "context", "attempts",
                 "content_key", "lease", "cache_hit")

    def __init__(self, stream_id: str, track_id: int, window_idx: int,
                 frame_idxs: Tuple[int, ...], payload: np.ndarray,
                 context: Any = None, content_key: Any = None,
                 lease: Any = None):
        self.stream_id = stream_id
        self.track_id = track_id
        self.window_idx = window_idx
        self.frame_idxs = frame_idxs
        self.payload = payload
        self.enqueue_t = time.monotonic()
        self.context = context
        self.attempts = 0
        self.content_key = content_key
        self.lease = lease
        self.cache_hit = False


class WindowDispatcher:
    """Round-robin submit + in-order collect between every stream's
    window queue and the serving micro-batcher.

    ``on_result(job, scores, error)`` is invoked from the collector
    thread: exactly one of ``scores`` (np.ndarray softmax row) and
    ``error`` (Exception) is not None.  Per-stream queues hold at most
    ``max_pending`` windows; a push beyond that drops the OLDEST pending
    window (counted via ``on_drop(job, reason)``) — under sustained
    overload the newest evidence wins.
    """

    def __init__(self, batcher, *, max_pending: int = 4,
                 request_timeout_s: float = 10.0,
                 shed_retries: int = 1,
                 on_result: Callable[[WindowJob, Optional[np.ndarray],
                                      Optional[BaseException]], None],
                 on_drop: Optional[Callable[[WindowJob, str], None]] = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.batcher = batcher
        self.max_pending = int(max_pending)
        #: bounded wait for a queue slot before drop-oldest fires (see
        #: push()); 0 restores the historical drop-immediately behavior
        self.push_grace_s = 0.02
        self.request_timeout_s = float(request_timeout_s)
        self.shed_retries = max(0, int(shed_retries))
        self._on_result = on_result
        self._on_drop = on_drop or (lambda job, reason: None)
        self._queues: "collections.OrderedDict[str, Deque[WindowJob]]" = \
            collections.OrderedDict()
        self._cv = threading.Condition()
        self._inflight: "queue.Queue[Tuple[WindowJob, Any]]" = queue.Queue()
        self._stop = threading.Event()
        self._submit_thread: Optional[threading.Thread] = None
        self._collect_thread: Optional[threading.Thread] = None
        self.submitted_total = 0
        self.dropped_total = 0
        self.shed_total = 0
        self.failed_total = 0
        self.scored_total = 0
        self.cache_hit_total = 0

    # ------------------------------------------------------------------
    def start(self) -> None:
        assert self._submit_thread is None, "dispatcher already started"
        self._submit_thread = threading.Thread(
            target=self._submit_loop, name="stream-window-submit",
            daemon=True)
        self._collect_thread = threading.Thread(
            target=self._collect_loop, name="stream-window-collect",
            daemon=True)
        self._submit_thread.start()
        self._collect_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in (self._submit_thread, self._collect_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._submit_thread = self._collect_thread = None

    # ------------------------------------------------------------------
    @staticmethod
    def _release_lease(job) -> None:
        """Terminal paths free the job's ring pins; idempotent (the
        engine's staging gather may already have consumed them)."""
        lease = getattr(job, "lease", None)
        if lease is not None:
            job.lease = None
            lease.release()

    def on_result(self, job: WindowJob, scores, error) -> None:
        """Guarded callback: an exception in the sink (event-log disk
        full, plugin bug) must not kill the dispatcher threads — every
        stream's verdicts would silently freeze while /healthz stays
        green."""
        self._release_lease(job)
        try:
            self._on_result(job, scores, error)
        except Exception:                          # noqa: BLE001
            _logger.exception("on_result sink failed for stream %s "
                              "window %d", job.stream_id, job.window_idx)

    def on_drop(self, job: WindowJob, reason: str) -> None:
        self._release_lease(job)
        try:
            self._on_drop(job, reason)
        except Exception:                          # noqa: BLE001
            _logger.exception("on_drop sink failed for stream %s",
                              job.stream_id)

    # ------------------------------------------------------------------
    def push(self, job: WindowJob) -> None:
        """Queue a window (ingest thread); drops oldest past the
        per-stream bound.

        A full queue first gets a short bounded grace (``push_grace_s``)
        for the submit thread to drain a slot: the frame-once assembly
        path emits a chunk's windows microseconds apart, so without the
        grace a burst smaller than the engine's throughput would shed
        windows purely because the submit thread hadn't had a GIL slice
        yet (the historical per-window copy chain paced this
        accidentally).  Under sustained overload the queue is still full
        when the grace lapses and the oldest window drops, exactly as
        before — bounded wait, never unbounded blocking."""
        deadline = None
        while True:
            with self._cv:
                q = self._queues.get(job.stream_id)
                if q is None:
                    q = self._queues[job.stream_id] = collections.deque()
                if len(q) < self.max_pending:
                    q.append(job)
                    self._cv.notify()
                    return
                now = time.monotonic()
                if deadline is None:
                    # no submit thread (unit tests, post-stop) ⇒ nothing
                    # will ever drain: drop immediately, as before
                    deadline = now + (self.push_grace_s
                                      if self._submit_thread is not None
                                      else 0.0)
                if now >= deadline:
                    dropped = q.popleft()
                    self.dropped_total += 1
                    q.append(job)
                    self._cv.notify()
                    break
            time.sleep(0.0005)
        self.on_drop(dropped, "backpressure")

    def drop_stream(self, stream_id: str) -> int:
        """Discard a closed stream's pending windows; returns the count."""
        with self._cv:
            q = self._queues.pop(stream_id, None)
        if not q:
            return 0
        for job in q:
            self.on_drop(job, "stream_closed")
        self.dropped_total += len(q)
        return len(q)

    def pending(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------------
    def _next_job(self) -> Optional[WindowJob]:
        """Round-robin pop: take from the first non-empty stream queue,
        then rotate it to the back so no stream can starve the rest."""
        with self._cv:
            while not self._stop.is_set():
                for sid in list(self._queues):
                    q = self._queues[sid]
                    if q:
                        job = q.popleft()
                        self._queues.move_to_end(sid)
                        return job
                self._cv.wait(timeout=0.1)
        return None

    def _submit_loop(self) -> None:
        from ..serving.batcher import QueueFull
        while not self._stop.is_set():
            job = self._next_job()
            if job is None:
                return
            try:
                if job.content_key is not None:
                    req = self.batcher.submit(
                        job.payload, timeout_s=self.request_timeout_s,
                        content_key=job.content_key)
                else:
                    req = self.batcher.submit(
                        job.payload, timeout_s=self.request_timeout_s)
            except QueueFull:
                if job.attempts < self.shed_retries:
                    # one paced retry before giving the window up: a shed
                    # is usually a transient spike, and the job goes back
                    # to the FRONT of its stream queue (still the oldest
                    # evidence there) while the backoff lets a batch
                    # drain.  Only if that queue still exists — re-
                    # creating one for a stream drop_stream just removed
                    # would leak the entry and score into a dead session.
                    requeued = False
                    with self._cv:
                        q = self._queues.get(job.stream_id)
                        if q is not None:
                            job.attempts += 1
                            q.appendleft(job)
                            requeued = True
                    if requeued:
                        time.sleep(0.005)
                        continue
                    self.dropped_total += 1
                    self.on_drop(job, "stream_closed")
                    continue
                self.shed_total += 1
                self.on_drop(job, "shed")
                continue
            except Exception as e:                 # noqa: BLE001
                self.failed_total += 1
                self.on_result(job, None, e)
                continue
            self.submitted_total += 1
            self._inflight.put((job, req))

    def _collect_loop(self) -> None:
        while True:
            try:
                job, req = self._inflight.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                scores = req.result(timeout=self.request_timeout_s + 5.0)
            except Exception as e:                 # noqa: BLE001
                self.failed_total += 1
                self.on_result(job, None, e)
                continue
            if getattr(req, "from_cache", False):
                self.cache_hit_total += 1
                job.cache_hit = True
            else:
                self.scored_total += 1
            self.on_result(job, np.asarray(scores), None)
