"""Stdlib HTTP front end: ``POST /score``, health/readiness, Prometheus
metrics.

The JAX package's front end (``deepfake_detection_tpu/serving/http.py``)
re-hosted on the port's engine, with its routes, bodies, status codes and
``Retry-After`` rules; ``multipart_boundary`` and ``split_multipart`` are
copies.  Only the frame decode differs, because the card's machine has no
Pillow: a blob that starts with numpy's magic ``\x93NUMPY`` is read by
``np.load(allow_pickle=False)`` and must be uint8 (H, W, 3); a JPEG (a blob
that starts ``FF D8 FF``) is decoded by the port's own decoder
(``data/native.py``, bitwise the libjpeg-turbo decode Pillow gives the JAX
server); a JPEG that decoder declines, and any other format, goes through
Pillow where it is installed.  Without Pillow the answer is 400: for a
declined JPEG naming the reason, for another format saying that it needs
Pillow and that ``.npy`` and JPEG frames need neither.

``http.server.ThreadingHTTPServer`` — one thread per connection, HTTP/1.1
keep-alive — is deliberately boring: the real concurrency is the
micro-batcher.  The handler threads do the per-request CPU work (decode,
resize to canvas) so it overlaps the engine thread's device calls.

Endpoints:

* ``POST /score`` — body is raw image bytes (``Content-Type: image/*``
  or ``application/octet-stream``), JSON ``{"image_b64": "..."}``, or a
  MULTI-FRAME clip: JSON ``{"frames_b64": [f1, ..., f_img_num]}`` or a
  ``multipart/*`` body with one image per part.  A single frame is
  replicated ×``img_num`` (the reference CLI's semantics); ``img_num``
  distinct frames are channel-concatenated into one temporal clip — and
  a clip of identical frames scores bit-identically to the replicate
  path (tests/test_serving.py).  On a multi-model engine a ``model``
  JSON field or ``?model=`` query param routes to one entry of the model
  table (unknown id = 400 listing the table); no ``model`` defaults to
  the flagship — or, when a cascade is configured, to student-first
  triage (suspects escalate to the flagship, the response then carries a
  ``cascade`` object with tier/student_score).  Responds
  ``{"fake_score": p, "scores": [...], "frames": n, "model": id,
  "timings_ms": {...}}``; 400 undecodable or a frame count other than
  1/``img_num``, 429 + jittered ``Retry-After`` when load-shedding, 503
  before warmup / while the circuit breaker is open / when the batch
  produced non-finite scores or was abandoned by the watchdog, 504 past
  the request deadline.
* ``GET /healthz`` — process liveness (200 while the process serves,
  INCLUDING during recovery re-warms — only readiness drops).
* ``GET /readyz`` — 200 only while every bucket is compiled+warmed AND
  no recovery re-warm or reload canary is in flight.  The body is the
  per-model readiness JSON (``engine.readiness_detail()``): a 503 with
  a parseable body tells a fleet router "cold model warming", no
  response at all means "engine down".
* ``GET /metrics`` — Prometheus text format (serving/metrics.py).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from ..cache import clip_phash, content_hash
from ..data import native
from ..params import normalize_concat, normalize_replicate, prepare_canvas
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .engine import InferenceEngine
from .metrics import ServingMetrics
from .resilience import BreakerOpen, EngineStalled, NonFiniteScores

_logger = logging.getLogger(__name__)

__all__ = ["ServingServer", "make_server", "serve_forever_in_thread",
           "multipart_boundary", "split_multipart"]

_MAX_BODY = 32 * 1024 * 1024            # 32 MiB: generous for one image
_NPY_MAGIC = b"\x93NUMPY"
NEEDS_PILLOW = ("undecodable image payload: this format needs Pillow, which "
                "is not installed; .npy frames (uint8 H×W×3) need only numpy "
                "and JPEG frames neither (the port decodes JPEG itself)")


class DeclinedJpeg(ValueError):
    """A JPEG the port's decoder declined, with no Pillow to fall back to."""


def decode_frame(blob: bytes) -> np.ndarray:
    """One request blob → uint8 (H, W, 3) RGB: ``.npy`` bytes by numpy, a
    JPEG by the port's decoder, anything else (or a declined JPEG) by
    Pillow, imported only then.  Raises ImportError for a non-JPEG format
    without Pillow, :class:`DeclinedJpeg` for a declined JPEG without
    Pillow and ValueError for an undecodable blob."""
    if blob.startswith(_NPY_MAGIC):
        try:
            img = np.load(io.BytesIO(blob), allow_pickle=False)
        except Exception as e:             # noqa: BLE001 — the 400 path
            raise ValueError(f"undecodable .npy frame: {e}") from e
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected a uint8 (H, W, 3) array, got "
                             f"{img.dtype} {img.shape}")
        return img
    declined = None
    if native.is_jpeg(blob):
        reasons: list = []
        img = native.decode_jpeg_bytes(blob, reasons=reasons)
        if img is not None:
            return img
        declined = reasons[0]
    try:
        from PIL import Image
    except ImportError:
        if declined is None:
            raise
        raise DeclinedJpeg(f"undecodable image payload: the port's JPEG "
                           f"decoder declined it ({declined}) and Pillow "
                           f"is not installed") from None
    try:
        with Image.open(io.BytesIO(blob)) as img:
            return np.asarray(img.convert("RGB"), np.uint8)
    except Exception as e:                 # noqa: BLE001 — the 400 path
        raise ValueError(f"undecodable image: {e}") from e


def multipart_boundary(ctype_full: str) -> Optional[str]:
    """Boundary token from a full Content-Type header value, or None.
    The one parser both ``POST /score`` and the stream ingest use."""
    import re
    m = re.search(r'boundary="?([^";]+)"?', ctype_full)
    return m.group(1) if m else None


def split_multipart(body: bytes, boundary: str) -> list:
    """MJPEG/multipart chunk → list of part payloads.

    Handles both ``multipart/x-mixed-replace`` (MJPEG-over-HTTP's
    framing) and ``multipart/form-data`` bodies: parts are delimited by
    ``--<boundary>``, each part's payload starts after its blank line.
    Lives here (not streaming/) because streaming is built ON TOP of
    serving — the dependency only points one way.
    """
    delim = b"--" + boundary.encode()
    parts = []
    for raw in body.split(delim)[1:]:      # [0] is the preamble
        if raw.startswith(b"--"):          # closing terminator
            break
        # one CRLF (or bare LF) follows the boundary line ...
        if raw.startswith(b"\r\n"):
            raw = raw[2:]
        elif raw.startswith(b"\n"):
            raw = raw[1:]
        # ... then an (optionally EMPTY) header block ends at the first
        # blank line.  Locate it before touching any payload bytes — a
        # JPEG legally contains 0d0a0d0a, so trimming first (the old
        # strip()) could eat the real delimiter and truncate the frame.
        if raw.startswith(b"\r\n"):
            payload = raw[2:]
        elif raw.startswith(b"\n"):
            payload = raw[1:]
        else:
            head_end = raw.find(b"\r\n\r\n")
            if head_end >= 0:
                payload = raw[head_end + 4:]
            else:
                head_end = raw.find(b"\n\n")
                payload = raw[head_end + 2:] if head_end >= 0 else raw
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        elif payload.endswith(b"\n"):
            payload = payload[:-1]
        if payload:
            parts.append(payload)
    return parts


class ServingServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the serving wiring."""

    daemon_threads = True
    # keep-alive matters: the load generator and any sane client reuse
    # connections, and accept() is the single-threaded part of this server
    protocol_version = "HTTP/1.1"
    # a router tier (or a bench loadgen) opens its whole connection pool
    # in one burst; the stdlib backlog of 5 would drop SYNs into 1s
    # retransmit stalls
    request_queue_size = 256

    def __init__(self, addr: Tuple[str, int], engine: InferenceEngine,
                 batcher: MicroBatcher, metrics: ServingMetrics,
                 request_timeout_s: float = 2.0, cascade=None):
        super().__init__(addr, _Handler)
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics
        self.request_timeout_s = float(request_timeout_s)
        #: optional serving/cascade.py CascadeRouter: when set, requests
        #: with no explicit ``model`` run student-first triage
        self.cascade = cascade


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # response headers + body are two writes; Nagle would hold the body
    # for the client's delayed ACK (~40 ms) on every small response
    disable_nagle_algorithm = True
    server: ServingServer   # typing aid

    # ------------------------------------------------------------------
    def log_message(self, fmt, *args):            # BaseHTTP logs to stderr
        _logger.debug("%s " + fmt, self.address_string(), *args)

    def _respond(self, status: int, body: bytes,
                 content_type: str = "application/json",
                 extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        self.server.metrics.count_request(status)

    def _respond_json(self, status: int, obj: dict,
                      extra_headers: Optional[dict] = None) -> None:
        self._respond(status, json.dumps(obj).encode(),
                      extra_headers=extra_headers)

    # ------------------------------------------------------------------
    def do_GET(self) -> None:                     # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._respond(200, b"ok\n", "text/plain")
        elif path == "/readyz":
            # JSON per-model readiness detail: the fleet
            # router's health scraper distinguishes "cold model warming"
            # (503 + parseable body, some model warmed=false) from
            # "engine down" (no response) without parsing metrics text
            detail = self.server.engine.readiness_detail()
            body = (json.dumps(detail, sort_keys=True) + "\n").encode()
            self._respond(200 if detail["ready"] else 503, body)
        elif path == "/metrics":
            text = self.server.metrics.render_prometheus()
            self._respond(200, text.encode(),
                          "text/plain; version=0.0.4; charset=utf-8")
        else:
            self._respond_json(404, {"error": f"no route {path!r}"})

    # ------------------------------------------------------------------
    def _read_body(self) -> Optional[bytes]:
        """Drain the request body (None = unreadable/oversize, connection
        will be closed).

        MUST run before any response on a POST: the connections are
        HTTP/1.1 keep-alive, so an unread body would be parsed as the
        next request line by the same socket's next round trip."""
        if self.headers.get("Transfer-Encoding"):
            # chunked bodies are unsupported and of unknown length —
            # poison the connection instead of the stream
            self.close_connection = True
            return None
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if not 0 <= length <= _MAX_BODY:
            # can't safely drain (unknown/huge length): poison the
            # connection instead of the stream
            self.close_connection = True
            return None
        return self.rfile.read(length)

    @staticmethod
    def _decode_frames(body: bytes, ctype_full: str
                       ) -> Tuple[Optional[list], Optional[str], str]:
        """Body bytes → (list of uint8 RGB frame arrays, JSON ``model``
        routing field, error); (None, _, error) if any frame is
        undecodable."""
        bad = "undecodable image payload"
        ctype = ctype_full.split(";")[0].strip()
        model = None
        if ctype == "application/json":
            try:
                payload = json.loads(body)
                if not isinstance(payload, dict):
                    return None, None, bad
                m = payload.get("model")
                model = m if isinstance(m, str) and m else None
                if "frames_b64" in payload:
                    blobs = [base64.b64decode(b, validate=True)
                             for b in payload["frames_b64"]]
                else:
                    b64 = payload.get("image_b64") or payload.get("image")
                    blobs = [base64.b64decode(b64, validate=True)]
            except (ValueError, TypeError, KeyError):
                return None, model, bad
        elif ctype.startswith("multipart/"):
            boundary = multipart_boundary(ctype_full)
            if not boundary:
                return None, None, bad
            blobs = split_multipart(body, boundary)
        else:
            blobs = [body]
        frames = []
        for blob in blobs:
            try:
                frames.append(decode_frame(blob))
            except ImportError:
                return None, model, NEEDS_PILLOW
            except DeclinedJpeg as e:
                return None, model, str(e)
            except ValueError:
                return None, model, bad
        return frames or None, model, bad

    @staticmethod
    def _payload_for(srv, entry, frames: list):
        """Frames → one wire payload for ``entry`` (its canvas size, its
        img_num): the float32 wire runs the full CLI preprocess on the
        handler thread, the uint8 wire ships the canvas and defers the
        photometrics to the device prologue.  One frame replicates
        ×img_num (reference CLI semantics), img_num distinct frames
        concatenate into one temporal clip.  Raises ValueError for a
        clip this entry can't take (the 400 path)."""
        canvases = [prepare_canvas(f, entry.image_size) for f in frames]
        return _Handler._payload_from(srv, entry, canvases)

    @staticmethod
    def _payload_from(srv, entry, canvases: list):
        if srv.engine.wire == "float32":
            if len(canvases) == 1:
                return normalize_replicate(canvases[0], entry.img_num)
            return normalize_concat(canvases)
        if len(canvases) == 1:
            return canvases[0]
        if not entry.multi_frame:
            raise ValueError(f"multi-frame clips are disabled for model "
                             f"{entry.model_id!r} on this uint8-wire "
                             f"engine")
        return np.concatenate(canvases, axis=-1)

    def do_POST(self) -> None:                    # noqa: N802 (stdlib API)
        t0 = time.monotonic()
        body = self._read_body()        # always drain before responding
        t_body = time.monotonic()       # preprocess stage must not bill a
        path, _, query = self.path.partition("?")   # slow client's socket
        if path != "/score":
            self._respond_json(404, {"error": f"no route {path!r}"})
            return
        srv = self.server
        if not srv.engine.ready:
            # warming up (any model of the table still cold), or the
            # watchdog is re-warming buckets after a recovery, or a
            # reload canary is in flight — /healthz stays 200 throughout,
            # only readiness drops
            self._respond_json(503, {"error": "model warming up"},
                               extra_headers={"Retry-After": 1})
            return
        try:
            # breaker shedding happens BEFORE body decode costs anything
            # beyond the mandatory keep-alive drain
            srv.engine.breaker.allow()
        except BreakerOpen as e:
            self._respond_json(
                503, {"error": "circuit breaker open, retry later"},
                extra_headers={"Retry-After":
                               max(1, int(round(e.retry_after_s)))})
            return
        ctype_full = self.headers.get("Content-Type") or ""
        frames, json_model, error = (
            self._decode_frames(body, ctype_full) if body
            else (None, None, "undecodable image payload"))
        if frames is None:
            self._respond_json(400, {"error": error})
            return
        # model routing: explicit ?model= / JSON field beats the default
        # (flagship, or student-first cascade when one is configured)
        requested = parse_qs(query).get("model", [None])[0] or json_model
        if requested is not None and not srv.engine.has_model(requested):
            self._respond_json(
                400, {"error": f"unknown model {requested!r}",
                      "models": list(srv.engine.model_ids())})
            return
        cascade = srv.cascade if (srv.cascade is not None
                                  and requested is None) else None
        entry = srv.engine.entry(
            cascade.student_id if cascade else requested)
        if len(frames) not in (1, entry.img_num):
            self._respond_json(
                400, {"error": f"need 1 or img_num={entry.img_num} "
                               f"frames, got {len(frames)}"})
            return
        try:
            canvases = [prepare_canvas(f, entry.image_size)
                        for f in frames]
            payload = self._payload_from(srv, entry, canvases)
        except ValueError as e:
            self._respond_json(400, {"error": str(e)})
            return
        # verdict-cache identity: hash the CANONICAL canvases (not the
        # wire bytes), so byte-identical re-uploads at any container or
        # encoding collide once decode+resize has normalized them; billed
        # to the preprocess stage like the canvas work it extends
        content_key = None
        if srv.batcher.cache is not None:
            content_key = (content_hash(canvases),
                           clip_phash(canvases)
                           if srv.batcher.cache.near_dup else None)
        t_pre = time.monotonic() - t_body     # decode+canvas only
        srv.metrics.latency["preprocess"].observe(t_pre)
        cas_result = None
        req = None
        try:
            if cascade is not None:
                flagship_entry = srv.engine.entry(cascade.flagship_id)
                # the flagship canvas is only prepared for the escalated
                # fraction (the thunk runs on this handler thread)
                cas_result = cascade.score(
                    payload,
                    lambda: self._payload_for(srv, flagship_entry,
                                              frames),
                    content_key=content_key)
                scores = cas_result.scores
            else:
                req = srv.batcher.submit(payload,
                                         timeout_s=srv.request_timeout_s,
                                         model_id=entry.model_id,
                                         content_key=content_key)
                # the batcher/engine enforce the queue-side deadline; the
                # extra 5s here only catches a wedged engine so the HTTP
                # thread can never hang forever
                scores = req.result(timeout=srv.request_timeout_s + 5.0)
        except QueueFull as e:
            self._respond_json(
                429, {"error": "overloaded, retry later",
                      "queue_depth": e.depth},
                extra_headers={"Retry-After":
                               max(1, int(round(e.retry_after_s)))})
            return
        except DeadlineExceeded:
            self._respond_json(504, {"error": "deadline exceeded"})
            return
        except (NonFiniteScores, EngineStalled) as e:
            # the request was fine, the serving set / engine was not:
            # 503 + Retry-After, never a silent NaN score or a 500 that
            # blames the client
            self._respond_json(503, {"error": f"scoring unavailable: {e}"},
                               extra_headers={"Retry-After": 1})
            return
        except Exception as e:                     # noqa: BLE001
            self._respond_json(500, {"error": f"scoring failed: {e!r}"})
            return
        total = time.monotonic() - t0
        srv.metrics.latency["total"].observe(total)
        served_model = entry.model_id if cas_result is None else (
            cascade.flagship_id if cas_result.tier == "flagship"
            else cascade.student_id)
        out = {
            "fake_score": float(scores[0]),
            "scores": [float(s) for s in scores],
            "frames": len(frames),
            "model": served_model,
            "timings_ms": {
                "preprocess": round(t_pre * 1000, 3),
                # cascade traffic reports the served tier's request
                # timings (CascadeResult.timings), not zeros
                "queue": round((req.timings if req is not None
                                else cas_result.timings
                                ).get("queue", 0.0) * 1000, 3),
                "device": round((req.timings if req is not None
                                 else cas_result.timings
                                 ).get("device", 0.0) * 1000, 3),
                "total": round(total * 1000, 3),
            },
        }
        if cas_result is not None:
            out["cascade"] = {
                "tier": cas_result.tier,
                "student_score": cas_result.student_score,
                "escalated": cas_result.escalated,
            }
            if cas_result.escalation_error:
                out["cascade"]["escalation_error"] = \
                    cas_result.escalation_error
        self._respond_json(200, out)


def make_server(host: str, port: int, engine: InferenceEngine,
                batcher: MicroBatcher, metrics: ServingMetrics,
                request_timeout_s: float = 2.0,
                cascade=None) -> ServingServer:
    return ServingServer((host, port), engine, batcher, metrics,
                         request_timeout_s, cascade=cascade)


def serve_forever_in_thread(server: ServingServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.1},
                         name="serving-http", daemon=True)
    t.start()
    return t
