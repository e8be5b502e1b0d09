"""Chunked stream ingest: per-stream HTTP sessions → decode → track →
window → engine.

Counterpart of ``deepfake_detection_tpu/streaming/ingest.py``: the same
routes, wires, books and snapshot schema (a snapshot or export of either
package imports into the other), and the same decode order: the port's own
JPEG decoder first (``data/native.py``, bitwise the JAX package's native
libjpeg pool), Pillow for what it declines and for other formats where
Pillow imports.  Without Pillow, a chunk holding a frame that is not a
JPEG answers 501 naming the raw wire.

This is the front half of the streaming-video workload: long-lived
*stream sessions* that accept frame sequences in chunks and run the
face-track → temporal-window → verdict pipeline against the serving
engine already resident in the process.  Transport is deliberately plain
HTTP/1.1 on the stdlib server (the serving subsystem's discipline — no
new dependency, keep-alive for cheap chunking):

* ``POST /streams``                    → open a session (201, stream_id)
* ``POST /streams/<id>/frames``        → one chunk of frames; the body is
  - ``multipart/x-mixed-replace`` — an MJPEG chunk (parts are JPEG),
  - ``image/*`` — a single encoded frame (JPEG, or anything Pillow
    decodes),
  - ``application/octet-stream`` — concatenated JPEGs (SOI/EOI scan),
  - ``application/x-dfd-raw`` — raw uint8 RGB frames, shape in the
    ``X-Frame-Width``/``X-Frame-Height`` headers (zero-decode path),
  - ``video/*`` — a container/elementary chunk for the **optional**
    ffmpeg demuxer adapter (soft dependency: 501 when no ffmpeg binary).
  The ack reports frames accepted, decode errors, windows emitted and
  the stream's current verdict, so a pushing client is also polling.
* ``GET /streams`` / ``GET /streams/<id>`` → listing / full status
  (tracks, verdict snapshots, recent schema-versioned events, counters).
* ``DELETE /streams/<id>``             → close, returning final status.
* ``POST /streams/<id>/migrate``       → quiesce + export the session as
  its ``dfd.streaming.session_state.v1`` snapshot (the ``--state-dir``
  machinery) and detach it; ``POST /streams/restore`` rebuilds the
  session from such a snapshot — together the live-migration pair the
  fleet router's drain path drives.  The one reserved id:
  ``POST /streams/restore`` is this verb, not a frame push to a stream
  named "restore".
* ``GET /healthz /readyz /metrics``    → liveness / bucket-warmup
  readiness / Prometheus (serving + streaming catalogs concatenated).

Decode fans a chunk's encoded frames out to a thread pool (the decoder's
ctypes call releases the GIL),
tracking/windowing run synchronously on the handler
thread (they are µs-scale and overlap the engine thread's device calls,
exactly like serving's preprocess), and scoring goes through
:class:`~deepfake_detection_tpu_torch.streaming.windows.WindowDispatcher`'s
bounded drop-oldest queues into the engine's fixed buckets — a stream
can stall, flood or die without recompiling, blocking or skewing anyone
else.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import subprocess
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data import native
from ..serving.http import multipart_boundary, split_multipart
from ..serving.listen import ReservedPortServer
from . import ring as ring_mod
from .metrics import StreamingMetrics
from .ring import CanvasRing, FrameStack, RingLease
from .tracker import GreedyIouTracker, crop_box, make_localizer
from .verdict import SEVERITY, VerdictMachine, VerdictThresholds
from .windows import TrackWindower, WindowDispatcher, WindowJob, build_payload

_logger = logging.getLogger(__name__)

__all__ = ["StreamSession", "StreamManager", "StreamServer",
           "multipart_boundary",
           "make_stream_server", "split_multipart", "split_jpeg_stream",
           "decode_frame_bytes", "decode_frames_batch", "decoder_available",
           "FfmpegDemuxer", "parse_verdict_vector"]

_MAX_BODY = 64 * 1024 * 1024     # one chunk of frames, not one image
_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")
_STATUS_SCHEMA = "dfd.streaming.status.v1"
#: session-durability snapshot schema — bump on any layout change so a
#: restore can reject snapshots it does not understand instead of
#: resuming from misread state
_STATE_SCHEMA = "dfd.streaming.session_state.v1"


# ---------------------------------------------------------------------------
# chunk parsing
# ---------------------------------------------------------------------------

# re-exported from serving/http.py (the byte-level multipart parsers
# live with the serving front end; streaming depends on serving, never
# the other way)


_SOI = b"\xff\xd8"
_EOI = b"\xff\xd9"


def split_jpeg_stream(body: bytes) -> List[bytes]:
    """Concatenated-JPEG scan: every SOI..EOI span becomes one frame.

    A raw EOI byte pair cannot appear inside entropy-coded data (JPEG
    byte-stuffs 0xFF00), so marker scanning is reliable for baseline
    MJPEG payloads; frames embedding thumbnails should use multipart
    framing instead.
    """
    frames: List[bytes] = []
    pos = 0
    while True:
        start = body.find(_SOI, pos)
        if start < 0:
            break
        end = body.find(_EOI, start + 2)
        if end < 0:
            break
        frames.append(body[start:end + 2])
        pos = end + 2
    return frames


#: the 501 a chunk with a non-JPEG frame gets where Pillow cannot be
#: imported
NO_DECODER = ("encoded frames other than JPEG need Pillow, which this "
              "interpreter cannot import (JPEG frames decode with the port's "
              "own decoder); send raw uint8 RGB frames as "
              "application/x-dfd-raw with X-Frame-Width/X-Frame-Height "
              "headers")


def decoder_available() -> bool:
    """Whether encoded frames can be decoded here: the port's JPEG decoder
    builds and loads."""
    return native.available()


def _pillow_importable() -> bool:
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return False
    return True


def decode_frame_bytes(data: bytes) -> Optional[np.ndarray]:
    """Encoded frame bytes → (H, W, 3) uint8, or None if undecodable: the
    port's JPEG decoder first, Pillow (imported at use) for what it
    declines, as the JAX package's ``decode_frame_bytes`` orders them."""
    arr = native.decode_jpeg_bytes(data)
    if arr is not None:
        return arr
    try:
        import io

        from PIL import Image
        img = Image.open(io.BytesIO(data))
        return np.asarray(img.convert("RGB"), np.uint8)
    except Exception:                              # noqa: BLE001 — 0-accept
        return None


_decode_pool = None
_decode_pool_lock = threading.Lock()


def _get_decode_pool():
    """Lazy shared decode fan-out pool.  ``decode_jpeg_bytes`` is a ctypes
    call into the port's decoder, which releases the GIL, so a chunk's
    frames decode in parallel on a thread pool.  Lazy so pure-host users
    (tests, raw-wire) never spawn the threads."""
    global _decode_pool
    if _decode_pool is None:
        with _decode_pool_lock:
            if _decode_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                workers = max(2, min(8, os.cpu_count() or 2))
                _decode_pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="stream-decode")
    return _decode_pool


def decode_frames_batch(encoded: List[bytes]) -> List[Optional[np.ndarray]]:
    """Decode a whole chunk's encoded frames in ONE fan-out to the
    decode pool instead of a
    serial per-frame loop; order is preserved, failures stay ``None``
    (counted by the caller).  Single frames skip the pool round-trip."""
    if len(encoded) < 2:
        return [decode_frame_bytes(d) for d in encoded]
    return list(_get_decode_pool().map(decode_frame_bytes, encoded))


def parse_verdict_vector(spec: str) -> List[float]:
    """Bench/test instrumentation: ``"0.05*8,0.95*12"`` → 20 planted
    per-window scores (``*N`` repeats; the last value holds forever).
    Empty spec → empty list (scores come from the model)."""
    out: List[float] = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "*" in tok:
            v, n = tok.split("*", 1)
            out.extend([float(v)] * int(n))
        else:
            out.append(float(tok))
    for v in out:
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"verdict vector value {v} outside [0, 1]")
    return out


# ---------------------------------------------------------------------------
# optional ffmpeg demuxer (container formats → MJPEG frames)
# ---------------------------------------------------------------------------

class FfmpegDemuxer:
    """Container-chunk adapter: a per-session ``ffmpeg`` subprocess
    transcoding whatever lands on stdin into an MJPEG stream on stdout,
    parsed incrementally by a reader thread.

    Soft dependency: :meth:`available` gates the route — the image does
    not ship ffmpeg, and nothing else imports this class.  Latency note:
    ffmpeg buffers internally, so frames from a fed chunk may only
    surface in a later ``poll_frames`` (or at :meth:`close`); acks count
    frames when they surface.
    """

    @staticmethod
    def available(binary: str = "ffmpeg") -> bool:
        return shutil.which(binary) is not None

    def __init__(self, binary: str = "ffmpeg"):
        if not self.available(binary):
            raise RuntimeError(f"ffmpeg binary {binary!r} not found")
        self._proc = subprocess.Popen(
            [binary, "-hide_banner", "-loglevel", "error", "-i", "pipe:0",
             "-f", "image2pipe", "-c:v", "mjpeg", "-q:v", "2", "pipe:1"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        self._frames: "queue.Queue[bytes]" = queue.Queue()
        self._closing = False        # close() in progress: an exit is
        # deliberate, not a mid-stream death
        self._reader = threading.Thread(target=self._read_loop,
                                        name="ffmpeg-demux", daemon=True)
        self._reader.start()

    @property
    def dead(self) -> bool:
        """ffmpeg exited on its own (killed, codec crash, corrupt input)
        — as opposed to a deliberate :meth:`close`.  The reader thread
        sees EOF and exits cleanly, so a death can never hang it; THIS
        flag is how the ingest path surfaces the failure as a counted
        per-stream error instead of silently dropping frames."""
        return not self._closing and self._proc.poll() is not None

    def _read_loop(self) -> None:
        buf = b""
        out = self._proc.stdout
        while True:
            # read1: return whatever the pipe has (>= 1 byte) instead of
            # blocking for a full 64 KiB — frames surface as ffmpeg emits
            # them, and a death is seen at the next EOF, not 64 KiB later
            chunk = out.read1(65536)
            if not chunk:
                break
            buf += chunk
            while True:
                start = buf.find(_SOI)
                if start < 0:
                    # a SOI can straddle the read boundary: keep a
                    # trailing 0xFF so the next chunk completes it
                    buf = buf[-1:] if buf.endswith(b"\xff") else b""
                    break
                end = buf.find(_EOI, start + 2)
                if end < 0:
                    buf = buf[start:]
                    break
                self._frames.put(buf[start:end + 2])
                buf = buf[end + 2:]

    def feed(self, data: bytes) -> None:
        # a pre-write poll catches a dead process even when the kernel
        # pipe buffer would have swallowed the bytes without an EPIPE
        if self._proc.poll() is not None:
            raise OSError(f"ffmpeg exited with code "
                          f"{self._proc.returncode} mid-stream")
        try:
            self._proc.stdin.write(data)
            self._proc.stdin.flush()
        except ValueError as e:       # stdin already closed
            raise OSError(str(e)) from None

    def poll_frames(self, wait_s: float = 0.2) -> List[bytes]:
        """Drain decoded frames; waits up to ``wait_s`` for the first."""
        frames: List[bytes] = []
        deadline = time.monotonic() + wait_s
        while True:
            try:
                frames.append(self._frames.get_nowait())
            except queue.Empty:
                if frames or time.monotonic() >= deadline:
                    return frames
                time.sleep(0.01)

    def close(self) -> List[bytes]:
        """Flush: close stdin so ffmpeg drains its pipeline, then return
        any trailing frames.  Safe to call on an already-dead process —
        the reader thread exits at stdout EOF (a death can't wedge it),
        and a terminate that won't die escalates to kill."""
        self._closing = True
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)
        self._proc.terminate()
        try:
            self._proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:          # pragma: no cover
            self._proc.kill()
            self._proc.wait(timeout=5.0)
        frames: List[bytes] = []
        while True:
            try:
                frames.append(self._frames.get_nowait())
            except queue.Empty:
                return frames


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------

class StreamSession:
    """One live stream: tracker + windower + verdict state + counters.

    Thread model: chunk ingest runs on HTTP handler threads, score
    results arrive on the dispatcher's collector thread; ``_lock``
    serializes both (a session is sequential by nature — frames have an
    order — so per-session locking costs nothing and keeps every piece
    of state consistent)."""

    def __init__(self, stream_id: str, cfg, dispatcher: WindowDispatcher,
                 metrics: StreamingMetrics, image_size: int, wire: str,
                 event_log_path: Optional[str] = None):
        self.id = stream_id
        self.cfg = cfg
        self.dispatcher = dispatcher
        self.metrics = metrics
        self.image_size = int(image_size)
        self.wire = wire
        self.created_t = time.time()
        self.last_activity = time.monotonic()
        self._lock = threading.RLock()
        self.localizer = make_localizer(cfg.localizer)
        self.tracker = GreedyIouTracker(
            iou_min=cfg.track_iou_min, ema_alpha=cfg.track_ema_alpha,
            max_coast=cfg.track_max_coast, min_hits=cfg.track_min_hits)
        #: 'ring' (frame-once fast path: preallocated crop rings, digests,
        #: zero-copy FrameStack payloads) or 'concat' (the historical
        #: standalone-canvas + np.concatenate path, kept as the in-tree
        #: parity/bench reference)
        self._assembly = getattr(cfg, "assembly", "ring")
        self._dedup = bool(getattr(cfg, "dedup_frames", False))
        self.windower = TrackWindower(
            cfg.img_num, stride=cfg.window_stride, hop=cfg.window_hop,
            digest_frames=(self._assembly == "ring"))
        #: per-track crop rings (frame-once path).  Capacity covers the
        #: windower span plus every window the per-stream queue bound
        #: allows in flight (+ headroom for engine-staged windows);
        #: exhaustion degrades to counted standalone rows, never a stall
        self._rings: Dict[int, CanvasRing] = {}
        self._ring_capacity = 1 + self.windower.span + self.windower.hop \
            * (int(getattr(cfg, "max_inflight_windows", 4)) + 4)
        self._norm: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # consecutive-duplicate elision state (dedup_frames): encoded-byte
        # digest + decoded array of the LAST frame, the localizer's last
        # detections (deterministic on pixels, so a byte-identical frame
        # reuses them), and each track's last submitted window key
        self._last_enc_digest: Optional[bytes] = None
        self._last_frame: Optional[np.ndarray] = None
        self._last_detections: Optional[Any] = None
        self._last_window_key: Dict[int, str] = {}
        # per-track (smoothed box, pinned FrameRef) of the last canvas
        # built: a byte-identical frame whose track box is exactly
        # unchanged yields an identical crop, so the previous ring row is
        # pinned again instead of re-running resize+pad+digest
        self._crop_memo: Dict[int, Tuple[Tuple[float, ...], Any]] = {}
        self.thresholds = VerdictThresholds(
            cfg.suspect_enter, cfg.suspect_exit,
            cfg.fake_enter, cfg.fake_exit)
        self.stream_verdict = VerdictMachine(
            self.thresholds, ema_alpha=cfg.verdict_ema_alpha,
            min_windows=cfg.verdict_min_windows,
            context={"stream_id": stream_id, "scope": "stream"})
        self.track_verdicts: Dict[int, VerdictMachine] = {}
        # bounded memory of retired tracks (newest last): a dead track's
        # frozen machine must not pin the stream verdict forever, but its
        # final state is still worth surfacing
        self.dead_tracks: "collections.deque" = collections.deque(
            maxlen=32)
        self.verdict_vector = parse_verdict_vector(
            getattr(cfg, "verdict_vector", ""))
        self.events: "list[dict]" = []
        self._event_limit = 256
        self._event_log_path = event_log_path
        self._event_log = None
        self.frame_idx = 0
        self.frames_ingested = 0
        self.decode_errors = 0
        self.demux_failures = 0
        self.windows_emitted = 0
        self.windows_scored = 0
        self.windows_dropped = 0
        self.windows_shed = 0
        self.windows_failed = 0
        self.windows_cache_hit = 0       # resolved from the verdict cache
        self.windows_dup_elided = 0      # identical clip content, skipped
        self.frames_dup_elided = 0       # byte-identical frames, no decode
        self.canvas_copies_elided = 0    # redundant staging copies skipped
        self.demuxer: Optional[FfmpegDemuxer] = None
        self.closed = False
        # migration export set this: the session object may still be
        # referenced by late collector callbacks, but its state has been
        # snapshotted and shipped — nothing may mutate books or metrics
        # behind the snapshot's back
        self.detached = False

    # ------------------------------------------------------------------
    def _emit(self, events: List[dict]) -> None:
        for ev in events:
            self.events.append(ev)
            if len(self.events) > self._event_limit:
                del self.events[:len(self.events) - self._event_limit]
            self.metrics.count_transition(ev["to"])
            if self._event_log_path and not self.closed:
                try:
                    if self._event_log is None:
                        self._event_log = open(self._event_log_path, "a")
                    self._event_log.write(
                        json.dumps(ev, sort_keys=True) + "\n")
                    self._event_log.flush()
                except OSError:
                    _logger.exception(
                        "stream %s: event log unwritable; disabling the "
                        "JSONL sink (events still served via status)",
                        self.id)
                    self._event_log_path = None
                    self._event_log = None

    # ------------------------------------------------------------------
    def touch(self) -> None:
        """Refresh the idle-eviction clock.  Called per CHUNK (not only
        when frames decode) — a stream steadily pushing chunks that
        ffmpeg is still buffering, or that all fail decode, is active,
        not idle."""
        with self._lock:
            self.last_activity = time.monotonic()

    def ingest_arrays(self, frames: List[np.ndarray],
                      dup_flags: Optional[List[bool]] = None
                      ) -> Dict[str, Any]:
        """Run decoded frames through localize → track → window →
        dispatch; returns the chunk ack.

        ``dup_flags[i]`` marks frame *i* byte-identical to its
        predecessor (:meth:`decode_chunk` dedup): the localizer —
        deterministic on pixels — is then skipped and its previous
        detections reused; the tracker still runs, so EMA box state stays
        bit-identical to ingesting the duplicate normally.

        The session lock is taken PER FRAME, not across the chunk: the
        process-wide collector thread needs the same lock to fold scores,
        and a single several-hundred-frame raw chunk must not freeze
        verdict folding for every other stream while its canvases
        resize."""
        emitted = 0
        for j, frame in enumerate(frames):
            dup = bool(dup_flags[j]) if dup_flags is not None else False
            with self._lock:
                self.last_activity = time.monotonic()
                closed = self.closed
                t0 = time.monotonic()
                if dup and self._last_detections is not None:
                    detections = self._last_detections
                else:
                    detections = self.localizer.localize(frame)
                self._last_detections = detections
                born0 = self.tracker.born_total
                upd = self.tracker.update(self.frame_idx, detections)
                self.metrics.tracks_born_total.inc(
                    self.tracker.born_total - born0)
                for t in upd.died:
                    self.windower.drop_track(t.id)
                    self._rings.pop(t.id, None)
                    self._last_window_key.pop(t.id, None)
                    memo = self._crop_memo.pop(t.id, None)
                    if memo is not None:
                        memo[1].decref()
                    vm = self.track_verdicts.pop(t.id, None)
                    if vm is not None:
                        self.dead_tracks.append(
                            {"track_id": t.id, **vm.snapshot()})
                    self.metrics.tracks_died_total.inc()
                for t in upd.fresh:
                    win = self._push_crop(t, frame, dup)
                    if win is not None:
                        emitted += self._emit_window(t.id, win, closed)
                self.frame_idx += 1
                self.frames_ingested += 1
                self.metrics.frames_ingested_total.inc()
                self.metrics.latency["track"].observe(
                    time.monotonic() - t0)
        return {"frames_accepted": len(frames), "windows_emitted": emitted}

    # -- frame-once fast path ------------------------------------------
    def _push_crop(self, track, frame: np.ndarray, dup: bool):
        """Track → crop → windower entry.  Ring mode runs
        ``prepare_canvas`` geometry straight into an acquired ring row
        (the frame's ONE copy) and digests it once; concat mode is the
        historical standalone-canvas path.  Under ``dedup_frames`` a
        byte-identical frame whose smoothed box is exactly unchanged
        provably yields the same canvas, so the previous row is pinned
        again (counted) instead of rebuilt."""
        track_id = track.id
        if self._assembly != "ring":
            crop = crop_box(frame, track.box, self.cfg.crop_margin)
            canvas = self._canvas(crop)
            return self.windower.push(track_id, self.frame_idx, canvas)
        memo = self._crop_memo.get(track_id) if self._dedup else None
        box = tuple(float(v) for v in track.box)
        if dup and memo is not None and memo[0] == box:
            ref = memo[1]
            ref.incref()                  # the new buffer entry's pin
            self._count_copies_elided(1)
            return self.windower.push(track_id, self.frame_idx,
                                      ref.canvas, digest=ref.digest,
                                      ref=ref)
        crop = crop_box(frame, track.box, self.cfg.crop_margin)
        ring = self._rings.get(track_id)
        if ring is None:
            ring = self._rings[track_id] = CanvasRing(
                self._ring_capacity, self.image_size)
        ref = ring.acquire()
        if ref.ring is None:              # pool exhausted: counted, safe
            self.metrics.ring_overflow_total.inc()
        self._canvas_into(ref.canvas, crop)
        ref.digest = ring_mod.frame_digest(ref.canvas)
        if self._dedup:
            ref.incref()                  # the memo slot's own pin
            if memo is not None:
                memo[1].decref()
            self._crop_memo[track_id] = (box, ref)
        return self.windower.push(track_id, self.frame_idx, ref.canvas,
                                  digest=ref.digest, ref=ref)

    def _emit_window(self, track_id: int, win, closed: bool) -> int:
        """Book one emitted window and stage it for scoring; returns 1
        when a job was dispatched (the ack's ``windows_emitted``)."""
        self.windows_emitted += 1
        self.metrics.windows_emitted_total.inc()
        if closed:
            # close-time tail (ffmpeg flush): scoring a window nobody can
            # observe would also leak a queue slot under a dead stream id
            # — count it dropped instead
            self.windows_dropped += 1
            self.metrics.windows_dropped_total.inc()
            self._release_window(win)
            return 0
        t0 = time.monotonic()
        key = None
        if win.digests is not None:
            key = ring_mod.window_key(win.digests)
            if self._dedup and key == self._last_window_key.get(track_id):
                # identical clip content as this track's previous window
                # (frozen/low-motion stream): the verdict machines already
                # consumed this exact evidence one hop ago — skip
                # submission entirely, counted, never silently
                self.windows_dup_elided += 1
                self.metrics.windows_dup_elided_total.inc()
                self._release_window(win)
                return 0
            self._last_window_key[track_id] = key
        if self._assembly == "ring":
            lease = RingLease(win.refs or [])
            payload = FrameStack(win.frames, norm=self._wire_norm(),
                                 on_consumed=lease.release)
        else:
            lease = None
            payload = build_payload(win.frames, self.wire,
                                    on_elide=self._count_copies_elided)
        content_key = (key, None) if key is not None and \
            self._cache_live() else None
        self.metrics.latency["assemble"].observe(time.monotonic() - t0)
        self.dispatcher.push(WindowJob(
            self.id, track_id, win.window_idx, win.frame_idxs, payload,
            context=self, content_key=content_key, lease=lease))
        return 1

    @staticmethod
    def _release_window(win) -> None:
        """Free the ring pins of a window that will never be dispatched
        (closed-stream tail, duplicate elision)."""
        if win.refs:
            for r in win.refs:
                r.decref()

    def _wire_norm(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Normalization constants for the float32 wire (None on uint8):
        the FrameStack gather applies the exact ``normalize_concat``
        per-frame expression while writing the batch slab."""
        if self.wire != "float32":
            return None
        if self._norm is None:
            from ..params import img_mean, img_std
            self._norm = (img_mean, img_std)
        return self._norm

    def _cache_live(self) -> bool:
        b = getattr(self.dispatcher, "batcher", None)
        return b is not None and getattr(b, "cache", None) is not None

    def _count_copies_elided(self, n: int) -> None:
        self.canvas_copies_elided += n
        self.metrics.canvas_copies_elided_total.inc(n)

    def current_verdict(self) -> str:
        """The status() verdict rule without building the whole status
        dict — the per-chunk ack path."""
        with self._lock:
            worst = self.stream_verdict.state
            for vm in self.track_verdicts.values():
                if SEVERITY[vm.state] > SEVERITY[worst]:
                    worst = vm.state
            return worst

    def _canvas(self, crop: np.ndarray) -> np.ndarray:
        """Crop → engine canvas: the CLI's exact geometric preprocess
        (aspect-preserving downfit + center pad), skipped when the crop
        already IS the canvas (the full-frame / pre-sized parity path —
        prepare_canvas is already a no-op there, this just saves work).
        The historical unconditional ``ascontiguousarray`` is elided
        (counted) for crops that are already contiguous."""
        h, w = crop.shape[:2]
        if crop.flags.c_contiguous:
            self._count_copies_elided(1)
        else:
            crop = np.ascontiguousarray(crop)
        if h == self.image_size and w == self.image_size:
            return crop
        from ..params import prepare_canvas
        return prepare_canvas(crop, self.image_size)

    def _canvas_into(self, row: np.ndarray, crop: np.ndarray) -> None:
        """``prepare_canvas`` written straight into a ring row — the
        frame's ONE copy.  Bit-identical to
        ``params.prepare_canvas(crop, image_size)``: same aspect-
        preserving BILINEAR downfit, same center zero-pad placement
        (``padding_image``'s ``(size - fitted) // 2`` top/left)."""
        h, w = crop.shape[:2]
        size = self.image_size
        if h == size and w == size:
            row[...] = crop               # pre-sized parity path: no-op fit
            return
        from ..params import resize
        if not crop.flags.c_contiguous:
            crop = np.ascontiguousarray(crop)
        fitted = resize(crop, (size, size))
        fh, fw = fitted.shape[:2]
        if fh == size and fw == size:
            row[...] = fitted
            return
        row[...] = 0
        top = (size - fh) // 2
        left = (size - fw) // 2
        row[top:top + fh, left:left + fw] = fitted

    # ------------------------------------------------------------------
    def decode_chunk(self, encoded: List[bytes]
                     ) -> Tuple[List[np.ndarray], List[bool], int]:
        """One chunk's encoded frames → (decoded arrays, per-frame dup
        flags, decode-error count), via ONE batched fan-out to the
        decode pool.

        With ``dedup_frames`` on, a frame whose encoded bytes digest
        equals its predecessor's skips decode entirely — counted
        (``frames_dup_elided``), never silent — and reuses the previous
        decoded array; a duplicate of an undecodable frame is an error
        without burning a decode (same bytes, same failure)."""
        if not self._dedup:
            decoded = decode_frames_batch(encoded)
            arrays = [a for a in decoded if a is not None]
            errors = len(decoded) - len(arrays)
            return arrays, [False] * len(arrays), errors
        with self._lock:
            prev_digest = self._last_enc_digest
            last = self._last_frame
        digests = [hashlib.sha256(d).digest() for d in encoded]
        dup: List[bool] = []
        unique_idx: List[int] = []
        p = prev_digest
        for i, dg in enumerate(digests):
            is_dup = p is not None and dg == p
            dup.append(is_dup)
            if not is_dup:
                unique_idx.append(i)
            p = dg
        by_idx = dict(zip(unique_idx, decode_frames_batch(
            [encoded[i] for i in unique_idx])))
        arrays: List[np.ndarray] = []
        flags: List[bool] = []
        errors = elided = 0
        for i in range(len(encoded)):
            if dup[i]:
                if last is None:
                    errors += 1
                else:
                    elided += 1
                    arrays.append(last)
                    flags.append(True)
            else:
                a = by_idx[i]
                last = a
                if a is None:
                    errors += 1
                else:
                    arrays.append(a)
                    flags.append(False)
        with self._lock:
            if digests:
                self._last_enc_digest = digests[-1]
                self._last_frame = last
            self.frames_dup_elided += elided
        if elided:
            self.metrics.frames_dup_elided_total.inc(elided)
        return arrays, flags, errors

    # ------------------------------------------------------------------
    def on_window_result(self, job: WindowJob,
                         scores: Optional[np.ndarray],
                         error: Optional[BaseException]) -> None:
        """Collector-thread callback: fold one window score into the
        track + stream verdict machines."""
        with self._lock:
            if self.detached:
                # exported mid-flight: the snapshot already booked this
                # window dropped — folding it here would double-count
                return
            if error is not None:
                self.windows_failed += 1
                self.metrics.windows_failed_total.inc()
                return
            fake = float(scores[0])
            if self.verdict_vector:
                # planted score (bench/test): indexed by arrival order —
                # cache hits arrive too, so the index is hits + scored
                i = min(self.windows_scored + self.windows_cache_hit,
                        len(self.verdict_vector) - 1)
                fake = self.verdict_vector[i]
            if getattr(job, "cache_hit", False):
                # resolved from the verdict cache: a real score for this
                # clip content, folded into the verdict machines like any
                # other — but booked as a hit, not a device window
                self.windows_cache_hit += 1
                self.metrics.windows_cache_hit_total.inc()
            else:
                self.windows_scored += 1
                self.metrics.windows_scored_total.inc()
            self.metrics.latency["score"].observe(
                time.monotonic() - job.enqueue_t)
            frame_idx = job.frame_idxs[-1]
            t = self.tracker.tracks.get(job.track_id)
            vm = self.track_verdicts.get(job.track_id)
            if vm is None and t is not None:    # late result for a dead
                vm = self.track_verdicts[job.track_id] = VerdictMachine(
                    self.thresholds, ema_alpha=self.cfg.verdict_ema_alpha,
                    min_windows=self.cfg.verdict_min_windows,
                    context={"stream_id": self.id, "scope": "track",
                             "track_id": job.track_id})
            if t is not None:
                t.windows_scored += 1
            if vm is not None:
                self._emit(vm.update(fake, frame_idx=frame_idx))
            self._emit(self.stream_verdict.update(fake,
                                                  frame_idx=frame_idx))

    def on_window_drop(self, job: WindowJob, reason: str) -> None:
        with self._lock:
            if self.detached:
                return         # already booked dropped by the snapshot
            if reason == "shed":
                self.windows_shed += 1
                self.metrics.windows_shed_total.inc()
            else:
                self.windows_dropped += 1
                self.metrics.windows_dropped_total.inc()

    # ------------------------------------------------------------------
    def status(self, *, events: int = 10) -> Dict[str, Any]:
        with self._lock:
            # stream verdict: the stream-scope machine (EMA over every
            # window, de-escalates naturally) escalated by any LIVE
            # track's machine — retired tracks no longer vote
            worst = self.stream_verdict.state
            for vm in self.track_verdicts.values():
                if SEVERITY[vm.state] > SEVERITY[worst]:
                    worst = vm.state
            return {
                "schema": _STATUS_SCHEMA,
                "stream_id": self.id,
                "created": self.created_t,
                "closed": self.closed,
                "verdict": worst,
                "stream": self.stream_verdict.snapshot(),
                "tracks": {
                    str(tid): vm.snapshot()
                    for tid, vm in sorted(self.track_verdicts.items())},
                "dead_tracks": list(self.dead_tracks),
                "active_tracks": self.tracker.snapshot(),
                "counters": {
                    "frames_ingested": self.frames_ingested,
                    "decode_errors": self.decode_errors,
                    "demux_failures": self.demux_failures,
                    "windows_emitted": self.windows_emitted,
                    "windows_scored": self.windows_scored,
                    "windows_dropped": self.windows_dropped,
                    "windows_shed": self.windows_shed,
                    "windows_failed": self.windows_failed,
                    "windows_cache_hit": self.windows_cache_hit,
                    "windows_dup_elided": self.windows_dup_elided,
                    "frames_dup_elided": self.frames_dup_elided,
                    "canvas_copies_elided": self.canvas_copies_elided,
                },
                "events": self.events[-events:],
            }

    def close(self) -> Dict[str, Any]:
        with self._lock:
            self.closed = True
            demuxer, self.demuxer = self.demuxer, None
        if demuxer is not None:
            # flush + terminate ffmpeg; trailing frames are discarded —
            # their windows could only complete AFTER the final status
            # below, so decoding them would be wasted work
            demuxer.close()
        st = self.status()
        with self._lock:
            if self._event_log is not None:
                self._event_log.close()
                self._event_log = None
            self._event_log_path = None
        return st

    # ------------------------------------------------------------------
    # durability: a server bounce must RESUME this stream's verdicts, not
    # reset them (tracker + verdict machines + window-position state all
    # round-trip; the verdict event log stays ONE coherent stream)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        with self._lock:
            # windows still in flight at snapshot time can never report
            # back into the restored session — account them dropped NOW so
            # the per-stream books (emitted == scored + dropped + shed +
            # failed + cache_hit + dup_elided) still balance after the
            # bounce
            pending = self.windows_emitted - self.windows_scored - \
                self.windows_dropped - self.windows_shed - \
                self.windows_failed - self.windows_cache_hit - \
                self.windows_dup_elided
            if pending > 0:
                self.windows_dropped += pending
                self.metrics.windows_dropped_total.inc(pending)
            return {
                "schema": _STATE_SCHEMA,
                "stream_id": self.id,
                "created": self.created_t,
                "frame_idx": self.frame_idx,
                "counters": {
                    "frames_ingested": self.frames_ingested,
                    "decode_errors": self.decode_errors,
                    "demux_failures": self.demux_failures,
                    "windows_emitted": self.windows_emitted,
                    "windows_scored": self.windows_scored,
                    "windows_dropped": self.windows_dropped,
                    "windows_shed": self.windows_shed,
                    "windows_failed": self.windows_failed,
                    "windows_cache_hit": self.windows_cache_hit,
                    "windows_dup_elided": self.windows_dup_elided,
                    "frames_dup_elided": self.frames_dup_elided,
                    "canvas_copies_elided": self.canvas_copies_elided,
                },
                "stream_verdict": self.stream_verdict.state_dict(),
                "track_verdicts": {
                    str(tid): vm.state_dict()
                    for tid, vm in sorted(self.track_verdicts.items())},
                "dead_tracks": list(self.dead_tracks),
                "events": self.events[-self._event_limit:],
                "tracker": self.tracker.state_dict(),
                "windower": self.windower.state_dict(),
            }

    def load_state(self, d: Dict[str, Any]) -> None:
        if d.get("schema") != _STATE_SCHEMA:
            raise ValueError(
                f"stream {self.id}: snapshot schema {d.get('schema')!r} "
                f"!= {_STATE_SCHEMA!r}; refusing to resume from it")
        if d.get("stream_id") != self.id:
            raise ValueError(f"snapshot is for stream "
                             f"{d.get('stream_id')!r}, not {self.id!r}")
        with self._lock:
            self.created_t = float(d["created"])
            self.frame_idx = int(d["frame_idx"])
            c = d["counters"]
            self.frames_ingested = int(c["frames_ingested"])
            self.decode_errors = int(c["decode_errors"])
            self.demux_failures = int(c.get("demux_failures", 0))
            self.windows_emitted = int(c["windows_emitted"])
            self.windows_scored = int(c["windows_scored"])
            self.windows_dropped = int(c["windows_dropped"])
            self.windows_shed = int(c["windows_shed"])
            self.windows_failed = int(c["windows_failed"])
            # older snapshots predate these terms (schema v1
            # layout unchanged — absent keys restore as 0)
            self.windows_cache_hit = int(c.get("windows_cache_hit", 0))
            self.windows_dup_elided = int(c.get("windows_dup_elided", 0))
            self.frames_dup_elided = int(c.get("frames_dup_elided", 0))
            self.canvas_copies_elided = int(
                c.get("canvas_copies_elided", 0))
            # duplicate-elision chains never cross a restore (the decoded
            # predecessor is gone) and restored windower entries live
            # outside the rings
            self._last_enc_digest = None
            self._last_frame = None
            self._last_detections = None
            self._last_window_key.clear()
            for _box, ref in self._crop_memo.values():
                ref.decref()
            self._crop_memo.clear()
            self._rings.clear()
            self.stream_verdict.load_state_dict(d["stream_verdict"])
            self.track_verdicts = {}
            for tid_s, vmd in d["track_verdicts"].items():
                tid = int(tid_s)
                vm = VerdictMachine(
                    self.thresholds, ema_alpha=self.cfg.verdict_ema_alpha,
                    min_windows=self.cfg.verdict_min_windows,
                    context={"stream_id": self.id, "scope": "track",
                             "track_id": tid})
                vm.load_state_dict(vmd)
                self.track_verdicts[tid] = vm
            self.dead_tracks.clear()
            self.dead_tracks.extend(d.get("dead_tracks", []))
            self.events = list(d.get("events", []))
            self.tracker.load_state_dict(d["tracker"])
            self.windower.load_state_dict(d["windower"])
            # the event log is APPENDED to across the bounce; a SIGTERM
            # can tear its last line, so reopen with the torn-tail repair
            # discipline — one coherent schema-versioned stream
            if self._event_log_path and \
                    os.path.exists(self._event_log_path):
                from ..obs.events import repair_torn_tail
                repair_torn_tail(self._event_log_path)
            self.last_activity = time.monotonic()


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

class StreamManager:
    """Session table: create/get/close, caps, idle (TTL) eviction, and
    the fan-in point the dispatcher routes results through."""

    def __init__(self, cfg, dispatcher: WindowDispatcher,
                 metrics: StreamingMetrics, image_size: int, wire: str):
        self.cfg = cfg
        self.dispatcher = dispatcher
        self.metrics = metrics
        self.image_size = int(image_size)
        self.wire = wire
        self._sessions: Dict[str, StreamSession] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._evictor: Optional[threading.Thread] = None

    # -- dispatcher callbacks (job.context is the session) -------------
    def on_result(self, job: WindowJob, scores, error) -> None:
        session: StreamSession = job.context
        session.on_window_result(job, scores, error)

    def on_drop(self, job: WindowJob, reason: str) -> None:
        session: StreamSession = job.context
        session.on_window_drop(job, reason)

    # ------------------------------------------------------------------
    def create(self, stream_id: Optional[str] = None) -> StreamSession:
        sid = stream_id or uuid.uuid4().hex[:12]
        if not _ID_RE.match(sid):
            raise ValueError(f"invalid stream id {sid!r} "
                             f"(need {_ID_RE.pattern})")
        log_path = None
        if self.cfg.event_log_dir:
            os.makedirs(self.cfg.event_log_dir, exist_ok=True)
            log_path = os.path.join(self.cfg.event_log_dir,
                                    f"{sid}.events.jsonl")
        with self._lock:
            if sid in self._sessions:
                raise KeyError(f"stream {sid!r} already exists")
            if len(self._sessions) >= self.cfg.max_streams:
                raise OverflowError(
                    f"at max_streams={self.cfg.max_streams}")
            s = StreamSession(sid, self.cfg, self.dispatcher, self.metrics,
                              self.image_size, self.wire,
                              event_log_path=log_path)
            self._sessions[sid] = s
            self.metrics.streams_opened_total.inc()
            self.metrics.active_streams = len(self._sessions)
        return s

    def get(self, stream_id: str) -> Optional[StreamSession]:
        with self._lock:
            return self._sessions.get(stream_id)

    def close(self, stream_id: str,
              evicted: bool = False) -> Optional[Dict[str, Any]]:
        with self._lock:
            s = self._sessions.pop(stream_id, None)
            self.metrics.active_streams = len(self._sessions)
        if s is None:
            return None
        self.dispatcher.drop_stream(stream_id)
        st = s.close()
        (self.metrics.streams_evicted_total if evicted
         else self.metrics.streams_closed_total).inc()
        self.refresh_track_gauge()
        return st

    def list_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._sessions)

    def refresh_track_gauge(self) -> None:
        with self._lock:
            self.metrics.active_tracks = sum(
                len(s.tracker.tracks) for s in self._sessions.values())

    # ------------------------------------------------------------------
    # session durability: shutdown snapshot + startup restore
    # ------------------------------------------------------------------
    def save_state(self, state_dir: str) -> int:
        """Snapshot every live session into ``state_dir`` (one JSON per
        stream, write → fsync → atomic rename — the checkpoint-writer
        discipline); returns how many were saved.  Called on shutdown/
        SIGTERM so a server bounce can resume verdict streams."""
        if not state_dir:
            return 0
        os.makedirs(state_dir, exist_ok=True)
        with self._lock:
            sessions = list(self._sessions.values())
        saved = 0
        for s in sessions:
            path = os.path.join(state_dir, f"{s.id}.state.json")
            try:
                data = json.dumps(s.state_dict(), sort_keys=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                saved += 1
            except (OSError, ValueError, TypeError):
                self.metrics.state_errors_total.inc()
                _logger.exception("stream %s: state snapshot failed "
                                  "(stream will RESET on restart)", s.id)
        if saved:
            _logger.info("saved %d stream session snapshot(s) to %s",
                         saved, state_dir)
        return saved

    def restore_state(self, state_dir: str) -> int:
        """Resume sessions from ``state_dir`` snapshots; returns how many.

        Each snapshot is CONSUMED (unlinked) on successful restore so a
        later crash-without-snapshot cannot resurrect stale state; a
        corrupt/unreadable snapshot is renamed ``.bad`` (kept for
        forensics, never retried) and counted, loudly."""
        if not state_dir or not os.path.isdir(state_dir):
            return 0
        restored = 0
        for name in sorted(os.listdir(state_dir)):
            if not name.endswith(".state.json"):
                continue
            path = os.path.join(state_dir, name)
            try:
                with open(path) as f:
                    d = json.load(f)
                s = self.create(d.get("stream_id"))
                try:
                    s.load_state(d)
                except Exception:
                    # half-restored sessions must not serve: drop it
                    self.close(s.id)
                    raise
            except Exception:                      # noqa: BLE001
                self.metrics.state_errors_total.inc()
                _logger.exception("cannot restore stream snapshot %s; "
                                  "renaming .bad", path)
                try:
                    os.replace(path, path + ".bad")
                except OSError:
                    pass
                continue
            os.unlink(path)
            restored += 1
            self.metrics.streams_restored_total.inc()
            _logger.info("resumed stream %s (verdict %r, %d windows "
                         "scored)", s.id, s.current_verdict(),
                         s.windows_scored)
        self.refresh_track_gauge()
        return restored

    # ------------------------------------------------------------------
    # live migration: export one session as the exact
    # --state-dir snapshot + restore it on another replica.  The fleet
    # router's drain path drives these through POST /streams/<id>/migrate
    # and POST /streams/restore; restart resume and migration
    # ride the SAME state_dict/load_state code.
    # ------------------------------------------------------------------
    def export_session(self, stream_id: str,
                       quiesce_s: float = 5.0) -> Optional[Dict[str, Any]]:
        """Detach one live session and return its state snapshot (None =
        unknown stream).

        Quiesce discipline (the runner's shutdown order, per-session):
        the session leaves the table first (no new chunks route to it),
        its queued windows are dropped (counted), then in-flight windows
        get up to ``quiesce_s`` to fold back before the snapshot books
        any stragglers dropped — per-stream books (emitted == scored +
        dropped + shed + failed) balance across the move exactly as they
        do across a restart."""
        with self._lock:
            s = self._sessions.pop(stream_id, None)
            self.metrics.active_streams = len(self._sessions)
        if s is None:
            return None
        self.dispatcher.drop_stream(stream_id)
        deadline = time.monotonic() + max(0.0, quiesce_s)
        while time.monotonic() < deadline:
            with s._lock:
                pending = s.windows_emitted - s.windows_scored - \
                    s.windows_dropped - s.windows_shed - \
                    s.windows_failed - s.windows_cache_hit - \
                    s.windows_dup_elided
            if pending <= 0:
                break
            time.sleep(0.02)
        with s._lock:
            state = s.state_dict()     # books stragglers dropped
            s.detached = True          # late results: touch nothing
            if s._event_log is not None:
                s._event_log.close()
                s._event_log = None
            s._event_log_path = None
        if s.demuxer is not None:
            try:
                s.demuxer.close()
            except Exception:                      # noqa: BLE001
                pass
        self.metrics.streams_migrated_out_total.inc()
        self.refresh_track_gauge()
        _logger.info("exported stream %s for migration (%d windows "
                     "scored)", stream_id,
                     state["counters"]["windows_scored"])
        return state

    def import_session(self, state: Dict[str, Any]) -> StreamSession:
        """Rebuild a session from an exported snapshot (the restore half
        of a migration).  Raises like :meth:`create` (KeyError if the id
        is live here, OverflowError at the cap) or ValueError for a
        snapshot this server can't resume; a half-restored session is
        dropped, never served."""
        sid = state.get("stream_id")
        s = self.create(sid)
        try:
            s.load_state(state)
        except Exception:
            self.close(s.id)
            raise
        self.metrics.streams_migrated_in_total.inc()
        self.refresh_track_gauge()
        _logger.info("imported stream %s (verdict %r, %d windows "
                     "scored)", s.id, s.current_verdict(),
                     s.windows_scored)
        return s

    # ------------------------------------------------------------------
    def start_evictor(self) -> None:
        if self.cfg.stream_ttl_s <= 0 or self._evictor is not None:
            return
        self._evictor = threading.Thread(target=self._evict_loop,
                                         name="stream-evictor", daemon=True)
        self._evictor.start()

    def _evict_loop(self) -> None:
        period = max(0.5, self.cfg.stream_ttl_s / 4.0)
        while not self._stop.wait(period):
            now = time.monotonic()
            with self._lock:
                idle = [sid for sid, s in self._sessions.items()
                        if now - s.last_activity > self.cfg.stream_ttl_s]
            for sid in idle:
                _logger.info("evicting idle stream %s", sid)
                self.close(sid, evicted=True)

    def shutdown(self) -> None:
        self._stop.set()
        if self._evictor is not None:
            self._evictor.join(timeout=5.0)
            self._evictor = None
        for sid in self.list_ids():
            self.close(sid)


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

_STREAM_PATH = re.compile(
    r"^/streams/([A-Za-z0-9_.-]{1,64})(/frames|/migrate)?$")


class StreamServer(ReservedPortServer):
    daemon_threads = True
    protocol_version = "HTTP/1.1"
    request_queue_size = 256     # the serving front end's burst-connect
    # discipline (router tier / many pushers connect at once)

    def __init__(self, addr: Tuple[str, int], manager: StreamManager,
                 engine, serving_metrics, metrics: StreamingMetrics):
        super().__init__(addr, _StreamHandler)
        self.manager = manager
        self.engine = engine
        self.serving_metrics = serving_metrics
        self.metrics = metrics


class _StreamHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True   # two-write responses vs delayed ACK
    server: StreamServer     # typing aid

    def log_message(self, fmt, *args):
        _logger.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing (the serving handler's keep-alive discipline) --------
    def _respond(self, status: int, body: bytes,
                 content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, obj: dict) -> None:
        self._respond(status, json.dumps(obj).encode())

    def _read_body(self) -> Optional[bytes]:
        """Drain the request body before ANY response (keep-alive: an
        unread body would be parsed as the next request line)."""
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            return None
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if not 0 <= length <= _MAX_BODY:
            self.close_connection = True
            return None
        return self.rfile.read(length)

    # ------------------------------------------------------------------
    def do_GET(self) -> None:                     # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        srv = self.server
        if path == "/healthz":
            self._respond(200, b"ok\n", "text/plain")
        elif path == "/readyz":
            # the serving front end's per-model JSON detail:
            # a fleet router distinguishes "cold model warming" from
            # "engine down" off this body
            detail = srv.engine.readiness_detail()
            body = (json.dumps(detail, sort_keys=True) + "\n").encode()
            self._respond(200 if detail["ready"] else 503, body)
        elif path == "/metrics":
            text = srv.serving_metrics.render_prometheus() + \
                srv.metrics.render_prometheus()
            self._respond(200, text.encode(),
                          "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/streams":
            ids = srv.manager.list_ids()
            self._json(200, {"streams": ids, "active": len(ids)})
        else:
            m = _STREAM_PATH.match(path)
            if m and not m.group(2):
                s = srv.manager.get(m.group(1))
                if s is None:
                    self._json(404, {"error": f"no stream {m.group(1)!r}"})
                else:
                    self._json(200, s.status())
            else:
                self._json(404, {"error": f"no route {path!r}"})

    def do_DELETE(self) -> None:                  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        m = _STREAM_PATH.match(path)
        if not m or m.group(2):
            self._json(404, {"error": f"no route {path!r}"})
            return
        st = self.server.manager.close(m.group(1))
        if st is None:
            self._json(404, {"error": f"no stream {m.group(1)!r}"})
        else:
            self._json(200, st)

    # ------------------------------------------------------------------
    def do_POST(self) -> None:                    # noqa: N802 (stdlib API)
        t0 = time.monotonic()
        body = self._read_body()
        path = self.path.split("?", 1)[0]
        srv = self.server
        if path == "/streams":
            self._create_stream(body)
            return
        if path == "/streams/restore":
            # migration restore (shadows a stream literally
            # named "restore" for this one verb — documented)
            self._restore_stream(body)
            return
        m = _STREAM_PATH.match(path)
        if not m or not m.group(2):
            self._json(404, {"error": f"no route {path!r}"})
            return
        if m.group(2) == "/migrate":
            self._migrate_stream(m.group(1))
            return
        if body is None:
            self._json(400, {"error": "unreadable/oversize body"})
            return
        if not srv.engine.ready:
            self._json(503, {"error": "model warming up"})
            return
        session = srv.manager.get(m.group(1))
        if session is None:
            self._json(404, {"error": f"no stream {m.group(1)!r}"})
            return
        srv.metrics.chunks_total.inc()
        session.touch()          # a pushing stream is active even if this
        try:                     # chunk yields no decodable frames yet
            ack = self._ingest_chunk(session, body)
        except _ChunkError as e:
            self._json(e.status, {"error": str(e)})
            return
        srv.manager.refresh_track_gauge()
        dt = time.monotonic() - t0
        srv.metrics.latency["ingest"].observe(dt)
        ack.update(stream_id=session.id,
                   verdict=session.current_verdict())
        self._json(200, ack)

    def _create_stream(self, body: Optional[bytes]) -> None:
        stream_id = None
        if body is None:         # unreadable/oversize — don't burn a
            self._json(400, {"error": "unreadable/oversize body"})
            return               # max_streams slot on a malformed request
        if body:
            try:
                payload = json.loads(body)
                stream_id = payload.get("stream_id") if \
                    isinstance(payload, dict) else None
            except ValueError:
                self._json(400, {"error": "body must be JSON"})
                return
        try:
            s = self.server.manager.create(stream_id)
        except KeyError as e:
            self._json(409, {"error": str(e)})
            return
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        except OverflowError as e:
            self._json(429, {"error": str(e)})
            return
        self._json(201, {"stream_id": s.id})

    # -- live migration ------------------------------------------------
    def _migrate_stream(self, stream_id: str) -> None:
        """Export + detach one session; the body IS the snapshot the
        caller (the fleet router's drain) restores elsewhere.  The
        session is gone from this server on 200 — a lost response means
        a lost session, which is why the router's migrate path restores
        back on failure and never drops the state on the floor."""
        state = self.server.manager.export_session(stream_id)
        if state is None:
            self._json(404, {"error": f"no stream {stream_id!r}"})
            return
        self._json(200, state)

    def _restore_stream(self, body: Optional[bytes]) -> None:
        if not body:
            self._json(400, {"error": "body must be a session snapshot "
                                      "(dfd.streaming.session_state.v1)"})
            return
        try:
            state = json.loads(body)
            if not isinstance(state, dict):
                raise ValueError("snapshot must be a JSON object")
        except ValueError as e:
            self._json(400, {"error": f"unparseable snapshot: {e}"})
            return
        try:
            s = self.server.manager.import_session(state)
        except KeyError as e:
            self._json(409, {"error": str(e)})
            return
        except OverflowError as e:
            self._json(429, {"error": str(e)})
            return
        except Exception as e:                     # noqa: BLE001
            self.server.metrics.state_errors_total.inc()
            self._json(400, {"error": f"cannot resume snapshot: {e!r}"})
            return
        self._json(201, {"stream_id": s.id,
                         "verdict": s.current_verdict(),
                         "windows_scored": s.windows_scored})

    # ------------------------------------------------------------------
    def _ingest_chunk(self, session: StreamSession,
                      body: bytes) -> Dict[str, Any]:
        ctype_full = self.headers.get("Content-Type") or \
            "application/octet-stream"
        ctype = ctype_full.split(";")[0].strip().lower()
        t0 = time.monotonic()
        if ctype.startswith("multipart/"):
            boundary = multipart_boundary(ctype_full)
            if not boundary:
                raise _ChunkError(400, "multipart body without boundary")
            encoded = split_multipart(body, boundary)
        elif ctype.startswith("image/"):
            encoded = [body]
        elif ctype == "application/x-dfd-raw":
            return self._ingest_raw(session, body, t0)
        elif ctype.startswith("video/") or ctype in (
                "application/mp4", "application/x-container"):
            return self._ingest_container(session, body, t0)
        else:                        # octet-stream: concatenated JPEGs
            encoded = split_jpeg_stream(body)
        if encoded and not decoder_available():
            raise _ChunkError(501, native.unavailable_reason())
        if any(not native.is_jpeg(d) for d in encoded) \
                and not _pillow_importable():
            raise _ChunkError(501, NO_DECODER)
        arrays, dup_flags, errors = session.decode_chunk(encoded)
        with session._lock:
            session.decode_errors += errors
        self.server.metrics.frames_decode_errors_total.inc(errors)
        self.server.metrics.latency["decode"].observe(
            time.monotonic() - t0)
        ack = session.ingest_arrays(arrays, dup_flags) if arrays else \
            {"frames_accepted": 0, "windows_emitted": 0}
        ack["decode_errors"] = errors
        return ack

    def _ingest_raw(self, session: StreamSession, body: bytes,
                    t0: float) -> Dict[str, Any]:
        try:
            w = int(self.headers["X-Frame-Width"])
            h = int(self.headers["X-Frame-Height"])
        except (KeyError, TypeError, ValueError):
            raise _ChunkError(400, "x-dfd-raw needs integer X-Frame-Width/"
                              "X-Frame-Height headers") from None
        frame_bytes = w * h * 3
        if w < 1 or h < 1 or not body or len(body) % frame_bytes:
            raise _ChunkError(400, f"body length {len(body)} is not a "
                              f"multiple of {h}x{w}x3")
        n = len(body) // frame_bytes
        arrays = list(np.frombuffer(body, np.uint8).reshape(n, h, w, 3))
        with session._lock:
            # raw frames break the encoded-byte duplicate chain: the next
            # encoded chunk's first frame is no longer "consecutive" with
            # the last encoded one
            session._last_enc_digest = None
            session._last_frame = None
        self.server.metrics.latency["decode"].observe(
            time.monotonic() - t0)
        ack = session.ingest_arrays(arrays)
        ack["decode_errors"] = 0
        return ack

    def _ingest_container(self, session: StreamSession, body: bytes,
                          t0: float) -> Dict[str, Any]:
        if not FfmpegDemuxer.available():
            raise _ChunkError(501, "container ingest needs an ffmpeg "
                              "binary on PATH (soft dependency, "
                              "not installed)")
        if not decoder_available():     # ffmpeg's MJPEG needs decoding
            raise _ChunkError(501, native.unavailable_reason())
        with session._lock:
            if session.demuxer is None:
                session.demuxer = FfmpegDemuxer()
            demuxer = session.demuxer
        try:
            demuxer.feed(body)
            encoded = demuxer.poll_frames()
            if demuxer.dead:
                # the process died AFTER accepting the bytes (kill, codec
                # crash mid-chunk): the reader saw EOF and exited, so
                # this surfaces here, counted — never as a silent stall
                raise OSError(f"ffmpeg exited with code "
                              f"{demuxer._proc.returncode} mid-stream")
        except OSError as e:
            # ffmpeg died (corrupt container, codec error, killed): count
            # it per-stream + process-wide, reset so the NEXT chunk gets
            # a fresh demuxer instead of a wedged pipe, and tell the
            # client instead of dropping the connection
            with session._lock:
                if session.demuxer is demuxer:
                    session.demuxer = None
                session.demux_failures += 1
            self.server.metrics.demux_failures_total.inc()
            try:
                demuxer.close()
            except Exception:                      # noqa: BLE001
                pass
            raise _ChunkError(
                422, f"ffmpeg demuxer failed ({e!r}); demuxer reset — "
                     f"resend from a container keyframe") from None
        arrays, dup_flags, errors = session.decode_chunk(encoded)
        with session._lock:
            session.decode_errors += errors
        self.server.metrics.frames_decode_errors_total.inc(errors)
        self.server.metrics.latency["decode"].observe(
            time.monotonic() - t0)
        ack = session.ingest_arrays(arrays, dup_flags) if arrays else \
            {"frames_accepted": 0, "windows_emitted": 0}
        ack["decode_errors"] = errors
        ack["note"] = "container frames surface as ffmpeg flushes"
        return ack


class _ChunkError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


def make_stream_server(host: str, port: int, manager: StreamManager,
                       engine, serving_metrics,
                       metrics: StreamingMetrics) -> StreamServer:
    return StreamServer((host, port), manager, engine, serving_metrics,
                        metrics)
