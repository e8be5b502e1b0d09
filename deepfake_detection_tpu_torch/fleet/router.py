"""The fleet router: a stdlib-HTTP tier in front of N shared-nothing
serve/stream replicas.

One Python process tops out on its host work (HTTP, decode, canvas,
normalize under one interpreter lock) before the card does — PERF.md §5
measures one port replica at ~70 clips/s at 32 clients against the
device's ~115.  The fleet answer is the
reference paper's: one worker per device behind a shared rendezvous,
here N independent ``runners/serve.py`` processes behind this router.
The router does strictly less per request than a replica (no JPEG
decode, no canvas resize, no JSON build — header parse + byte relay on
keep-alive sockets), so each replica added is a full unit of host *and*
device capacity.

Routing:

* ``POST /score`` (stateless) — least-depth eligible replica (scraped
  queue depth + inflight + this router's own outstanding proxies).  An
  upstream 429/503 marks the replica backed-off for its **Retry-After**
  (shed-aware: the hint is honored before any failover lands there
  again) and the request fails over to the next eligible replica;
  transport errors likewise.  When no replica remains the router sheds
  503 with a **jittered** Retry-After (the serving stack's idiom — a constant
  would synchronize every client into one resend wave).
* ``/streams/*`` (session-affine) — consistent-hash affinity
  (``registry.HashRing``): deterministic across router restarts, so a
  rebooted router keeps sending each stream to the replica holding its
  session.  A migration override (written when a drain moves a session)
  beats the ring.  Affine traffic never fails over — the session state
  has exactly one home — a down home replica is an honest 503 +
  Retry-After until it returns (``--state-dir`` restores its sessions on
  relaunch).
* Router-owned: ``/healthz``, ``/readyz`` (ready while ≥1 replica is
  eligible; JSON per-replica detail), ``/metrics`` (``dfd_router_*``
  catalog + every replica's exposition re-labeled ``replica="<id>"``),
  ``/replicas`` (+ ``POST /replicas/<id>/drain|undrain`` — drain
  live-migrates the replica's streams via fleet/migrate.py).

Books (asserted exactly by ``chip_smoke.py``'s router phase)::

    routed == cache_hit + forwarded + migrated + shed + failed

``cache_hit`` is the optional **edge verdict cache**: whole
``POST /score`` responses keyed on the exact request bytes under the
fleet *weights-epoch* (:class:`EdgeCache`), resolved at the router
without touching a replica.

The counterpart of ``deepfake_detection_tpu/fleet/router.py``: the cache
is the port's ``cache.VerdictCache``, Retry-After the port's
``serving.resilience.jittered_retry_after``, and the epoch reads each
replica's ``/readyz`` ``models[*].fingerprint``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import random
import re
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Set, Tuple

from ..cache import VerdictCache
from ..serving.resilience import jittered_retry_after
from .controller import HealthScraper, http_request
from .metrics import RouterMetrics, relabel_exposition
from .migrate import drain_replica, undrain_replica
from .registry import Registry, Replica

_logger = logging.getLogger(__name__)

__all__ = ["RouterServer", "make_router_server", "EdgeCache",
           "FORWARD_HEADER_EXCLUDES", "readyz_document",
           "aggregate_metrics_text", "merged_streams",
           "replica_operation", "ensure_stream_id",
           "autoscaler_document"]

_MAX_BODY = 64 * 1024 * 1024          # one frame chunk, not one image
_STREAM_PATH = re.compile(
    r"^/streams/([A-Za-z0-9_.-]{1,64})(/frames|/migrate)?$")
_REPLICA_PATH = re.compile(r"^/replicas/([^/]+)(/drain|/undrain)?$")

#: hop-by-hop / recomputed headers never forwarded upstream
FORWARD_HEADER_EXCLUDES = frozenset(
    {"host", "connection", "content-length", "transfer-encoding",
     "keep-alive"})

# ---------------------------------------------------------------------------
# control-plane documents, shared verbatim by BOTH data planes (threads
# here, the event loop in fleet/dataplane.py) — extracting them
# is what makes the aggregate /metrics re-export and the /readyz JSON
# byte-identical across planes by construction
# ---------------------------------------------------------------------------

def readyz_document(registry: Registry,
                    metrics: RouterMetrics) -> Tuple[int, bytes]:
    """(status, body) of ``GET /readyz``: ready while ≥1 replica is
    eligible, with the per-replica JSON detail."""
    counts = registry.counts()
    metrics.set_fleet_gauges(counts)
    body = (json.dumps({
        "ready": counts["eligible"] > 0,
        "counts": counts,
        "replicas": {r.id: r.summary() for r in registry.all()},
    }, sort_keys=True) + "\n").encode()
    return (200 if counts["eligible"] > 0 else 503), body


def aggregate_metrics_text(registry: Registry,
                           metrics: RouterMetrics) -> str:
    """Router catalog + every replica's last exposition re-labeled
    ``replica="<id>"`` (one scrape sees the whole fleet)."""
    metrics.set_fleet_gauges(registry.counts())
    lines = [metrics.render_prometheus().rstrip("\n")]
    seen: Set[str] = set()
    for r in registry.all():
        if r.exposition:
            lines.extend(relabel_exposition(r.exposition, r.id, seen))
    return "\n".join(lines) + "\n"


def merged_streams(registry: Registry, timeout_s: float) -> dict:
    """Fleet-wide stream listing (one blocking round trip per healthy
    replica — control plane, never the hot path)."""
    streams: Dict[str, str] = {}
    for r in registry.all():
        if not r.healthy:
            continue
        try:
            _, _, body = http_request(r.netloc, "GET", "/streams",
                                      timeout=timeout_s)
            for sid in json.loads(body).get("streams", []):
                streams[sid] = r.id
        except (OSError, ValueError):
            continue
    return {"streams": sorted(streams),
            "active": len(streams),
            "by_replica": streams}


def replica_operation(registry: Registry, metrics: RouterMetrics,
                      drain_lock: threading.Lock, replica_id: str,
                      op: str, migrate_timeout_s: float
                      ) -> Tuple[int, dict]:
    """(status, JSON body) of ``POST /replicas/<id>[/drain|/undrain]``.
    Blocking (migrations run inside) — control plane only."""
    if registry.get(replica_id) is None:
        return 404, {"error": f"unknown replica {replica_id!r}",
                     "replicas": registry.ids()}
    if op == "/drain":
        with drain_lock:
            return 200, drain_replica(registry, metrics, replica_id,
                                      timeout_s=migrate_timeout_s)
    if op == "/undrain":
        with drain_lock:
            return 200, undrain_replica(registry, metrics, replica_id)
    return 404, {"error": "POST /replicas/<id>/drain or /undrain"}


def autoscaler_document(autoscaler) -> Tuple[int, bytes]:
    """(status, body) of ``GET /autoscaler`` — shared by both data
    planes.  404 while autoscaling is off (the runner attaches the
    autoscaler to the server object when ``--autoscale`` is set)."""
    if autoscaler is None:
        return 404, (json.dumps({"enabled": False,
                                 "error": "autoscaler disabled "
                                          "(--autoscale)"},
                                sort_keys=True) + "\n").encode()
    return 200, (json.dumps(autoscaler.status(), sort_keys=True)
                 + "\n").encode()


def ensure_stream_id(body: bytes) -> Tuple[Optional[str], bytes]:
    """(stream id, possibly-rewritten body) for POST /streams; id is
    None when the body is unparseable (400 path).  Creation must pass
    through the router so it can hash the id — a client that did not
    name one gets a router-assigned id injected into the body."""
    payload: dict = {}
    if body:
        try:
            payload = json.loads(body)
        except ValueError:
            return None, body
        if not isinstance(payload, dict):
            return None, body
    sid = payload.get("stream_id")
    if not sid:
        sid = uuid.uuid4().hex[:12]
        payload["stream_id"] = sid
        body = json.dumps(payload).encode()
    return str(sid), body


class EdgeCache:
    """Router-edge verdict cache: whole ``POST /score``
    responses keyed on the exact request bytes, shared by BOTH data
    planes.

    The store is the torch-free :class:`~..cache.VerdictCache` under a
    synthetic model id ``"edge"`` whose *fingerprint* is the **fleet
    weights-epoch**: a digest of every ready replica's
    ``{model: checkpoint-fingerprint}`` map from its scraped ``/readyz``
    detail.  Any hot reload or quantized swap anywhere in the fleet
    moves a replica fingerprint, therefore the epoch, therefore the
    addressable key space — old entries are orphaned (and eagerly
    cleared) rather than invalidated one by one, the same story as the
    in-replica cache.

    Two honesty rules:

    * while ANY ready replica's readiness detail lacks model
      fingerprints (scrape not landed yet, mixed versions mid-rollout)
      the epoch is ``None`` and the cache **bypasses** — correctness
      never leans on scrape freshness;
    * the epoch only moves when a scrape lands, so an edge hit can be
      stale by at most ``min(ttl, scrape interval)`` after a reload —
      which is why the edge TTL defaults to seconds where the
      in-replica cache (exact by construction) defaults to minutes.
    """

    __slots__ = ("store", "registry", "max_value_bytes", "_epoch",
                 "_epoch_sig", "_epoch_docs")

    def __init__(self, registry: Registry, entries: int, ttl_s: float,
                 *, max_value_bytes: int = 1 << 20):
        self.store = VerdictCache(int(entries), float(ttl_s))
        self.registry = registry
        # streamed / oversize responses are relayed, never buffered for
        # the cache: the router's memory bound stays the relay bound
        self.max_value_bytes = int(max_value_bytes)
        # epoch memo keyed on every replica's health, readiness and the
        # identity of its last readiness doc (the scraper replaces the
        # dict wholesale).  The memo holds the docs it was computed from:
        # a freed doc's address can go to a later one, and ``id()`` only
        # names an unchanged doc while the doc is alive.  Unsynchronized
        # by design: the worst data race costs one redundant recompute.
        self._epoch: Optional[str] = None
        self._epoch_sig: Optional[tuple] = None
        self._epoch_docs: tuple = ()

    @staticmethod
    def request_key(method: str, target: str, content_type: str,
                    body: bytes) -> str:
        """Exact byte identity of one request: method + target
        (query included) + content type + raw body."""
        h = hashlib.sha256()
        h.update(method.encode("latin-1", "replace"))
        h.update(b"\0")
        h.update(target.encode("latin-1", "replace"))
        h.update(b"\0")
        h.update((content_type or "").encode("latin-1", "replace"))
        h.update(b"\0")
        h.update(body)
        return h.hexdigest()

    def epoch(self) -> Optional[str]:
        view = self.registry.view()
        docs = tuple(r.readiness for r in view)
        sig = tuple((r.id, r.healthy, r.ready, id(d))
                    for r, d in zip(view, docs))
        if sig == self._epoch_sig:
            return self._epoch
        pairs: Optional[Set[str]] = set()
        for r, doc in zip(view, docs):
            if not (r.healthy and r.ready):
                continue
            models = (doc or {}).get("models")
            if not isinstance(models, dict) or not models:
                pairs = None
                break
            for mid, det in models.items():
                fp = det.get("fingerprint") \
                    if isinstance(det, dict) else None
                if not fp:
                    pairs = None
                    break
                pairs.add(f"{mid}={fp}")
            if pairs is None:
                break
        epoch = (hashlib.sha256("\n".join(sorted(pairs)).encode())
                 .hexdigest() if pairs else None)
        if self._epoch is not None and epoch != self._epoch:
            # the epoch moved (reload / membership change): every held
            # entry is unaddressable — reclaim eagerly
            self.store.clear()
        self._epoch_sig, self._epoch, self._epoch_docs = sig, epoch, docs
        return epoch

    def get(self, key: str):
        """(status, content_type, body) | None."""
        ep = self.epoch()
        if ep is None:
            return None
        return self.store.get(key, "edge", ep)

    def put(self, key: str, status: int, content_type: str,
            body: bytes) -> None:
        ep = self.epoch()
        if ep is None or len(body) > self.max_value_bytes:
            return
        self.store.put(key, "edge", ep,
                       (int(status), content_type, body))


#: per-thread upstream connection pool ({replica_id: _UpstreamConn}).
#: ThreadingHTTPServer runs one thread per client connection and clients
#: keep-alive, so the pool amortizes the upstream TCP handshake to zero
#: on the steady path — the router must do LESS host work per request
#: than a replica, or the fleet could never clear the host ceiling.
_tls = threading.local()


class _UpstreamConn:
    """One keep-alive raw socket to a replica with a minimal HTTP/1.1
    response reader (status line + headers + Content-Length body).

    ``http.client`` costs ~as much per round trip as the replica's own
    GIL-bound request handling — mostly ``email.parser`` on the response
    headers — which would cap the fleet near 1× no matter how many
    replicas sit behind the router (the JAX package's records measure
    the raw reader at about twice the relays a second on a CPU box).
    The replicas always answer with Content-Length (the serving/streaming
    handlers never chunk), so the minimal reader is exact, and an
    upstream ``Connection: close`` marks the socket stale instead of
    being reused."""

    __slots__ = ("sock", "rfile", "stale")

    def __init__(self, netloc: str, timeout_s: float):
        host, port = netloc.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb")
        self.stale = False

    def close(self) -> None:
        try:
            self.rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def round_trip(self, head: bytes,
                   body: bytes) -> Tuple[int, dict, bytes]:
        """Send one pre-serialized request, read one response.  Raises
        OSError on any transport/parse failure (caller drops the conn)."""
        try:
            self.sock.sendall(head + body if body else head)
            line = self.rfile.readline(65537)
            if not line:
                raise OSError("upstream closed the connection")
            status = int(line.split(b" ", 2)[1])
            hdrs: Dict[str, str] = {}
            while True:
                h = self.rfile.readline(65537)
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.partition(b":")
                hdrs[k.strip().lower().decode("latin-1")] = \
                    v.strip().decode("latin-1")
            length = int(hdrs.get("content-length", 0))
            data = self.rfile.read(length) if length > 0 else b""
            if len(data) != length:
                raise OSError("short upstream body")
        except (ValueError, IndexError) as e:
            raise OSError(f"unparseable upstream response: {e}") from e
        if hdrs.get("connection", "").lower() == "close":
            self.stale = True
        return status, hdrs, data


class RouterServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the fleet wiring."""

    daemon_threads = True
    protocol_version = "HTTP/1.1"
    # a fleet's worth of clients connects in one burst; the stdlib
    # default backlog of 5 turns that into SYN drops + 1s retransmit
    # stalls that read as mysterious tail latency
    request_queue_size = 256

    def __init__(self, addr: Tuple[str, int], registry: Registry,
                 metrics: RouterMetrics, scraper: HealthScraper, *,
                 route_retries: int = 2, upstream_timeout_s: float = 30.0,
                 shed_retry_after_s: float = 1.0,
                 retry_jitter_s: float = 2.0,
                 migrate_timeout_s: float = 30.0,
                 idle_timeout_s: float = 60.0,
                 header_timeout_s: float = 10.0,
                 max_buffer_bytes: int = 1 << 20,
                 edge_cache_entries: int = 0,
                 edge_cache_ttl_s: float = 2.0):
        super().__init__(addr, _RouterHandler)
        self.registry = registry
        self.metrics = metrics
        self.scraper = scraper
        self.route_retries = max(0, int(route_retries))
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.retry_jitter_s = float(retry_jitter_s)
        self.migrate_timeout_s = float(migrate_timeout_s)
        # slowloris/idle hardening, matched by the evloop
        # plane: idle keep-alive connections and stalled header reads
        # are closed on deadline instead of pinning a thread forever
        self.idle_timeout_s = float(idle_timeout_s)
        self.header_timeout_s = float(header_timeout_s)
        # per-connection relay buffer bound — only the evloop plane
        # buffers, but both planes accept the knob so RouterConfig can
        # drive either through one kwargs dict
        self.max_buffer_bytes = int(max_buffer_bytes)
        # optional edge verdict cache: 0 entries = off
        self.edge_cache = (
            EdgeCache(registry, edge_cache_entries, edge_cache_ttl_s,
                      max_value_bytes=self.max_buffer_bytes)
            if int(edge_cache_entries) > 0 else None)
        # seeded: deterministic under test, de-correlated in production
        # (per-process stream)
        self._shed_rng = random.Random(0x0F1EE7)
        self._shed_rng_lock = threading.Lock()
        #: serializes drain/undrain (a drain mid-drain would double-move)
        self._drain_lock = threading.Lock()
        #: the control loop, attached by the runner when
        #: --autoscale is set; serves GET /autoscaler on both planes
        self.autoscaler = None

    def shed_retry_after(self) -> float:
        """Router-level shed Retry-After: base + bounded uniform jitter
        (serving/resilience.py's ``jittered_retry_after`` — the serving
        stack's idiom, pinned by a seeded-rng spread test)."""
        with self._shed_rng_lock:
            return jittered_retry_after(self.shed_retry_after_s,
                                        self.retry_jitter_s,
                                        self._shed_rng)


class _Headers(dict):
    """Minimal case-insensitive header map (keys stored lower-case) —
    just the surface the proxy path reads (``get``/``items``)."""

    def get(self, key, default=None):          # noqa: A003 (stdlib API)
        return dict.get(self, key.lower(), default)


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # headers and body go out as two writes; with Nagle on, the second
    # waits on the client's delayed ACK of the first (~40 ms a hop) —
    # the classic small-response stall, measured on this box
    disable_nagle_algorithm = True
    server: RouterServer      # typing aid

    def log_message(self, fmt, *args):
        _logger.debug("%s " + fmt, self.address_string(), *args)

    def setup(self) -> None:
        # arm the idle deadline as the socket timeout: a keep-alive
        # connection that goes quiet stops costing a thread at
        # idle_timeout_s instead of forever
        self.timeout = self.server.idle_timeout_s
        # bytes read past the head terminator (the head read pulls one
        # raw recv at a time, which can over-read into the body or the
        # next pipelined request); consumed before rfile everywhere
        self._head_excess = b""
        super().setup()

    # Date-header cache: BaseHTTP's send_response runs strftime per
    # response; at fleet rates that is real GIL time.  Worst case of the
    # benign class-attr race is one redundant strftime.
    _date_second = -1
    _date_value = ""

    def send_response(self, code, message=None):
        self.log_request(code)
        self.send_response_only(code, message)
        self.send_header("Server", "dfd-router")
        now = int(time.time())
        cls = _RouterHandler
        if cls._date_second != now:
            cls._date_value = self.date_time_string()
            cls._date_second = now
        self.send_header("Date", cls._date_value)

    def handle_one_request(self) -> None:
        """Minimal HTTP/1.1 request read for the proxy hot path.

        BaseHTTPRequestHandler parses headers through ``email.parser`` —
        roughly the same GIL-bound cost as a whole raw relay — so the
        stock loop would spend more on parsing than on routing and cap
        the fleet's aggregate near 1×.  This override keeps the stdlib
        server's connection/dispatch semantics (keep-alive, 501 on
        unknown verbs, timeouts poison the connection) with a plain
        split parse over the raw head.  No Expect: 100-continue
        handling — the serving stack's clients never send it.

        The whole head (request line + headers) is read via
        ``rfile.read1`` — at most ONE raw recv per call — under a
        socket timeout that shrinks toward a hard deadline: the first
        byte may wait out the idle timeout (quiet keep-alive), but once
        any byte has arrived the complete head is owed within
        header_timeout_s.  A per-recv timeout alone (readline) would
        let a client trickling bytes — even within a single header
        line — reset it forever while pinning this thread."""
        self.command = self.requestline = ""
        self.request_version = self.protocol_version
        srv = self.server
        try:
            buf, self._head_excess = self._head_excess, b""
            deadline = 0.0            # armed at the first head byte
            try:
                while True:
                    i = buf.find(b"\r\n\r\n")
                    sep = 4
                    if i < 0:
                        i = buf.find(b"\n\n")
                        sep = 2
                    if i >= 0:
                        break
                    if len(buf) > 65536:
                        self.send_error(414)
                        return
                    now = time.monotonic()
                    if buf and deadline == 0.0:
                        deadline = now + srv.header_timeout_s
                    if deadline:
                        remaining = deadline - now
                        if remaining <= 0:
                            raise TimeoutError("header deadline")
                        self.connection.settimeout(remaining)
                    else:
                        self.connection.settimeout(srv.idle_timeout_s)
                    try:
                        chunk = self.rfile.read1(65536)
                    except TimeoutError:
                        if deadline == 0.0:
                            # idle deadline between requests: quiet
                            # keep-alive connection, close without a
                            # response (same as evloop)
                            srv.metrics.idle_closed_total.inc()
                            self.close_connection = True
                            return
                        raise
                    if not chunk:
                        self.close_connection = True
                        return
                    buf += chunk
            except TimeoutError:
                srv.metrics.idle_closed_total.inc()
                self.close_connection = True
                self.wfile.write(b"HTTP/1.1 408 Request Timeout\r\n"
                                 b"Content-Length: 0\r\n"
                                 b"Connection: close\r\n\r\n")
                srv.metrics.count_request(408)
                return
            self._head_excess = buf[i + sep:]
            lines = buf[:i].split(b"\n")
            line = lines[0].decode("latin-1").rstrip("\r")
            parts = line.split()
            if len(parts) != 3:
                self.close_connection = True
                if line:
                    self.send_error(400, "malformed request line")
                return
            self.command, self.path, self.request_version = parts
            self.requestline = line
            headers = _Headers()
            for hl in lines[1:]:
                k, hsep, v = hl.decode("latin-1").partition(":")
                if hsep:
                    headers[k.strip().lower()] = v.strip()
            self.connection.settimeout(srv.idle_timeout_s)
            self.headers = headers
            conn_tok = headers.get("connection", "").lower()
            if self.request_version == "HTTP/1.0":
                self.close_connection = conn_tok != "keep-alive"
            else:
                self.close_connection = conn_tok == "close"
            method = getattr(self, "do_" + self.command, None)
            if method is None:
                self.send_error(
                    501, f"Unsupported method ({self.command!r})")
                return
            method()
            self.wfile.flush()
        except TimeoutError:
            # body-read (or response-write) stall past the idle
            # deadline: poison the connection, count the close
            srv.metrics.idle_closed_total.inc()
            self.close_connection = True
        except OSError:
            # client vanished mid-request (reset/EPIPE on a write):
            # every route path settles its book before writing to the
            # client, so just poison the connection quietly
            self.close_connection = True

    # -- plumbing (the serving handler's keep-alive discipline) --------
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

    def _json(self, status: int, obj: dict,
              extra_headers: Optional[dict] = None) -> None:
        self._respond(status, json.dumps(obj).encode(),
                      extra_headers=extra_headers)

    def _read_body(self) -> Optional[bytes]:
        """Drain the body before ANY response (keep-alive: an unread
        body would be parsed as the next request line)."""
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
        excess = self._head_excess
        if excess:
            # the head read over-ran into the body: consume that first
            head, self._head_excess = excess[:length], excess[length:]
            need = length - len(head)
            if need:
                return head + self.rfile.read(need)
            return head
        return self.rfile.read(length)

    # ------------------------------------------------------------------
    # router-owned endpoints
    # ------------------------------------------------------------------
    def do_GET(self) -> None:                     # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        srv = self.server
        if path == "/healthz":
            self._respond(200, b"ok\n", "text/plain")
        elif path == "/readyz":
            status, body = readyz_document(srv.registry, srv.metrics)
            self._respond(status, body)
        elif path == "/metrics":
            self._respond(200, aggregate_metrics_text(
                srv.registry, srv.metrics).encode(),
                "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/replicas":
            self._json(200, {r.id: r.summary()
                             for r in srv.registry.all()})
        elif path == "/autoscaler":
            status, body = autoscaler_document(
                getattr(srv, "autoscaler", None))
            self._respond(status, body)
        elif path == "/streams":
            self._json(200, merged_streams(srv.registry,
                                           srv.upstream_timeout_s))
        else:
            self._proxy("GET", None)

    def do_POST(self) -> None:                    # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        m = _REPLICA_PATH.match(path)
        if m:
            self._read_body()                     # drain (keep-alive)
            self._replica_op(m.group(1), m.group(2) or "")
            return
        self._proxy("POST", None)

    def do_DELETE(self) -> None:                  # noqa: N802 (stdlib API)
        self._proxy("DELETE", None)

    # ------------------------------------------------------------------
    def _replica_op(self, replica_id: str, op: str) -> None:
        srv = self.server
        status, doc = replica_operation(srv.registry, srv.metrics,
                                        srv._drain_lock, replica_id, op,
                                        srv.migrate_timeout_s)
        self._json(status, doc)

    # ------------------------------------------------------------------
    # proxy path — every resolution increments EXACTLY one book
    # ------------------------------------------------------------------
    def _proxy(self, method: str, _unused) -> None:
        t0 = time.monotonic()
        srv = self.server
        body = self._read_body()
        if body is None:
            self._json(400, {"error": "unreadable/oversize body"})
            return
        path, _, query = self.path.partition("?")
        target = path + ("?" + query if query else "")
        m = _STREAM_PATH.match(path)
        if not (path == "/score" or
                (path == "/streams" and method == "POST") or m):
            self._json(404, {"error": f"no route {path!r}"})
            return
        # client-error rejections resolve BEFORE the books: routed only
        # counts requests the router actually tried to place
        if m and m.group(2) == "/migrate" and method == "POST":
            # migration/restore are the ROUTER's verbs (POST /replicas/
            # <id>/drain): moving a session behind the router's back
            # would leave its affinity pointing at a replica that no
            # longer holds it
            self._json(400, {"error": "migrate via POST "
                                      "/replicas/<id>/drain"})
            return
        if path == "/streams/restore" and method == "POST":
            self._json(400, {"error": "restore via POST "
                                      "/replicas/<id>/drain (a restore "
                                      "bypassing the router desyncs "
                                      "stream affinity)"})
            return
        sid = None
        if method == "POST" and path == "/streams":
            # creation: the router must know the id to hash it — inject
            # one when the client didn't name it
            sid, body = ensure_stream_id(body)
            if sid is None:
                self._json(400, {"error": "body must be empty or a JSON "
                                          "object"})
                return
        srv.metrics.routed_total.inc()
        try:
            if path == "/score":
                cache, cache_key = srv.edge_cache, None
                if cache is not None:
                    cache_key = EdgeCache.request_key(
                        method, target,
                        self.headers.get("content-type", ""), body)
                    hit = cache.get(cache_key)
                    if hit is not None:
                        # edge verdict-cache resolution: one book, no
                        # replica touched
                        srv.metrics.cache_hit_total.inc()
                        self._relay(hit[0], {"content-type": hit[1]},
                                    hit[2])
                        return
                self._route_stateless(method, target, body,
                                      cache_key=cache_key)
            else:
                self._route_stream(method, path, target, body,
                                   create_sid=sid)
        finally:
            srv.metrics.latency["total"].observe(time.monotonic() - t0)

    def _shed(self, note: str, extra: Optional[dict] = None) -> None:
        srv = self.server
        srv.metrics.shed_total.inc()
        ra = srv.shed_retry_after()
        self._json(503, {"error": note, **(extra or {})},
                   extra_headers={"Retry-After": max(1, round(ra))})

    def _fail(self, note: str) -> None:
        self.server.metrics.failed_total.inc()
        self._json(502, {"error": note})

    def _pooled_conn(self, r: Replica) -> Tuple["_UpstreamConn", bool]:
        """(connection, was_reused) from this thread's upstream pool.

        The pool is pruned whenever the registry generation moved
        (replica removed or down-marked): sockets to retired replicas
        close instead of leaking one FD per pool owner until the thread
        dies."""
        srv = self.server
        pool = getattr(_tls, "pool", None)
        if pool is None:
            pool = _tls.pool = {}
            _tls.generation = -1
        gen = srv.registry.generation
        if _tls.generation != gen:
            _tls.generation = gen
            for rid in list(pool):
                rep = srv.registry.get(rid)
                if rep is None or not rep.healthy:
                    pool.pop(rid).close()
                    srv.metrics.upstream_pool_closed_total.inc()
        conn = pool.get(r.id)
        if conn is not None:
            return conn, True
        conn = _UpstreamConn(r.netloc, srv.upstream_timeout_s)
        pool[r.id] = conn
        return conn, False

    def _drop_conn(self, r: Replica) -> None:
        pool = getattr(_tls, "pool", None)
        conn = pool.pop(r.id, None) if pool else None
        if conn is not None:
            conn.close()

    def _send_upstream(self, r: Replica, method: str, target: str,
                       body: bytes) -> Tuple[int, dict, bytes]:
        """One upstream round trip on this thread's keep-alive pool,
        with inflight + latency accounting.  A failure on a REUSED
        connection retries once on a fresh socket — but ONLY the
        idled-out-keep-alive class (EOF/reset): a TIMEOUT means the
        replica may have fully received (and be processing) the request,
        and resending a non-idempotent POST there would double-deliver —
        e.g. a frame chunk ingested twice, breaking the bit-identical
        replay contract.  Real transport failures raise OSError."""
        srv = self.server
        head = self._upstream_head(r, method, target, len(body))
        srv.registry.note_dispatch(r.id)
        t0 = time.monotonic()
        try:
            for _ in range(2):
                conn, reused = self._pooled_conn(r)
                try:
                    out = conn.round_trip(head, body)
                    if conn.stale:
                        self._drop_conn(r)
                    return out
                except OSError as e:
                    self._drop_conn(r)
                    if not reused or isinstance(e, TimeoutError):
                        raise OSError(
                            f"upstream {r.id} failed: {e!r}") from e
            raise OSError(f"upstream {r.id} failed twice")
        finally:
            srv.registry.note_done(r.id)
            srv.metrics.latency["upstream"].observe(
                time.monotonic() - t0)

    def _upstream_head(self, r: Replica, method: str, target: str,
                       body_len: int) -> bytes:
        """Pre-serialized upstream request head (raw-socket data plane:
        the router must do LESS HTTP work per request than a replica, so
        the relay skips http.client's object churn both ways)."""
        parts = [f"{method} {target} HTTP/1.1\r\nHost: {r.netloc}\r\n"]
        for k, v in self.headers.items():
            if k.lower() not in FORWARD_HEADER_EXCLUDES:
                parts.append(f"{k}: {v}\r\n")
        parts.append(f"Content-Length: {body_len}\r\n\r\n")
        return "".join(parts).encode("latin-1")

    def _relay(self, status: int, hdrs: dict, rbody: bytes) -> None:
        extra = {}
        if "retry-after" in hdrs:
            extra["Retry-After"] = hdrs["retry-after"]
        self._respond(status, rbody,
                      hdrs.get("content-type", "application/json"),
                      extra_headers=extra)

    @staticmethod
    def _retry_after_of(hdrs: dict, default: float = 1.0) -> float:
        try:
            return float(hdrs.get("retry-after", default))
        except (TypeError, ValueError):
            return default

    def _route_stateless(self, method: str, target: str, body: bytes,
                         cache_key: Optional[str] = None) -> None:
        """Least-depth routing with shed-aware failover: an upstream
        429/503 backs the replica off for its Retry-After and the
        request moves on; transport errors likewise.  Exactly one book
        resolution on every path out.  A 200 relay populates the edge
        cache when the probe missed (``cache_key`` carries the probe's
        request digest)."""
        srv = self.server
        tried: Set[str] = set()
        saw_transport_error = False
        saw_shed = False
        for attempt in range(1 + srv.route_retries):
            r = srv.registry.pick_stateless(exclude=tried)
            if r is None:
                break
            tried.add(r.id)
            if attempt:
                srv.metrics.retries_total.inc()
            try:
                status, hdrs, rbody = self._send_upstream(
                    r, method, target, body)
            except OSError:
                saw_transport_error = True
                _logger.warning("replica %s: transport error on %s "
                                "(failing over)", r.id, target)
                continue
            if status in (429, 503):
                saw_shed = True
                srv.registry.mark_shed(r.id,
                                       self._retry_after_of(hdrs))
                continue
            srv.metrics.forwarded_total.inc()
            srv.metrics.count_forward(r.id)
            if cache_key is not None and status == 200:
                srv.edge_cache.put(
                    cache_key, status,
                    hdrs.get("content-type", "application/json"), rbody)
            self._relay(status, hdrs, rbody)
            return
        if saw_transport_error and not saw_shed:
            # nothing shed us — the fleet is unreachable, not overloaded
            self._fail("replica transport errors exhausted the "
                       "failover budget")
            return
        self._shed("fleet overloaded or no eligible replica, retry "
                   "later", {"tried": sorted(tried)})

    def _route_stream(self, method: str, path: str, target: str,
                      body: bytes,
                      create_sid: Optional[str] = None) -> None:
        """Session-affine routing: overrides (migration) beat the ring;
        no failover — a session has exactly one home."""
        srv = self.server
        creating = create_sid is not None
        if creating:
            sid = create_sid
            # a NEW stream re-using a migrated-then-closed id must bind
            # to its ring home, not the stale migration target
            srv.registry.clear_override(sid)
        else:
            sid = _STREAM_PATH.match(path).group(1)
        r, via_override = srv.registry.pick_stream(sid)
        if r is None:
            self._shed("no replicas registered")
            return
        if not (r.healthy and r.ready) or (r.draining and creating):
            # down home: honest shed until it returns (its sessions
            # restore from --state-dir on relaunch) or a drain migrates
            # the stream; draining replicas take no NEW streams
            self._shed(f"stream home replica {r.id} unavailable",
                       {"replica": r.id})
            return
        try:
            status, hdrs, rbody = self._send_upstream(r, method, target,
                                                      body)
        except OSError:
            self._fail(f"stream home replica {r.id} transport error")
            return
        if method == "DELETE" and 200 <= status < 300:
            # the session is gone: drop its migration override so the
            # overrides map cannot grow one stale entry per migrated
            # stream for the router's lifetime (replica-side TTL
            # eviction still leaks its entry until the id is reused or
            # re-created — bounded by drains, not by traffic)
            srv.registry.clear_override(sid)
        (srv.metrics.migrated_total if via_override
         else srv.metrics.forwarded_total).inc()
        srv.metrics.count_forward(r.id)
        self._relay(status, hdrs, rbody)


def make_router_server(host: str, port: int, registry: Registry,
                       metrics: Optional[RouterMetrics] = None,
                       scraper: Optional[HealthScraper] = None, *,
                       data_plane: str = "threads",
                       relay_workers: int = 1, **kw):
    """Build a router server on the chosen data plane.

    ``threads`` (default): :class:`RouterServer`, one thread per client
    connection.  ``evloop``: the non-blocking event loop
    (``fleet/dataplane.py``), same control plane and books, one loop
    thread (``relay_workers`` shards accept across N loops via
    SO_REUSEPORT).  Both return objects with the same serve_forever /
    shutdown / server_close / server_address surface.
    """
    metrics = metrics if metrics is not None else RouterMetrics()
    scraper = scraper if scraper is not None else HealthScraper(
        registry, metrics)
    if data_plane == "evloop":
        # lazy import: dataplane imports this module's shared helpers
        from .dataplane import EvLoopRouterServer
        return EvLoopRouterServer((host, port), registry, metrics,
                                  scraper, relay_workers=relay_workers,
                                  **kw)
    if data_plane != "threads":
        raise ValueError(f"data_plane must be 'threads' or 'evloop', "
                         f"got {data_plane!r}")
    return RouterServer((host, port), registry, metrics, scraper, **kw)
