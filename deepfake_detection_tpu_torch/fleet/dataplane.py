"""Event-loop data plane: the router hot path.

The threads plane spends its per-request work under one interpreter
lock (one thread per connection, header parse + byte relay), which caps
the relays a router makes a second no matter how many replicas sit
behind it (the JAX package's records measure that cap on a CPU box).
This module rebuilds the hot path as a single-threaded non-blocking
event loop on stdlib ``selectors`` (epoll on Linux; ``--relay-workers
N`` shards accept across N loops via SO_REUSEPORT):

* each accepted connection is a small state machine (``_Conn``) that
  parses exactly enough of the request head to resolve the route —
  method, path, Content-Length framing — then **splices bytes** between
  the client socket and a pooled non-blocking upstream socket with zero
  re-parsing and zero re-serialization: the upstream's response bytes
  are forwarded verbatim;
* deadlines (header-read, idle, upstream) live on a hashed timer wheel
  (``_TimerWheel``) — O(1) arm/advance, lazily re-filed, so slowloris
  and idle hardening cost nothing on the steady path;
* routing state is read lock-free (``Registry.view()`` /
  ``pick_stateless_fast`` / ``pick_stream_fast`` — immutable snapshot +
  GIL-atomic attribute reads), so the loop thread never blocks on the
  scraper;
* blocking control-plane verbs (``GET /streams`` fan-out, ``POST
  /replicas/<id>/drain|undrain`` migrations) run on ONE control worker
  thread and post completions back through a socketpair wake — the loop
  never blocks on them.

Behavior contract: identical to the threads plane.  Same RouterConfig,
same consistent-hash affinity, same shed-aware failover honoring
upstream Retry-After, same drain/migration overrides, same books
(``routed == cache_hit + forwarded + migrated + shed + failed``,
exactly one resolution per routed request), the same optional edge
verdict cache (``EdgeCache``, shared class), and the same
control-plane documents —
shared verbatim via ``fleet/router.py``'s module-level helpers, so the
aggregate ``/metrics`` re-export and ``/readyz`` JSON are byte-identical
across planes by construction.  tests/test_torch_fleet.py runs
parametrized over both planes to pin this.

One deliberate divergence: a response larger than ``max_buffer_bytes``
is **streamed** (forwarded chunk-by-chunk with writability-gated
backpressure) instead of buffered.  The threads plane always buffers;
for streamed responses a mid-stream upstream tear after bytes already
reached the client cannot fail over — the connection closes and the
request books ``failed`` (exactly one resolution, still).

Must stay torch-free.  The counterpart of
``deepfake_detection_tpu/fleet/dataplane.py``.
"""

from __future__ import annotations

import errno
import json
import logging
import queue
import random
import selectors
import socket
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..serving.resilience import jittered_retry_after
from .controller import HealthScraper
from .metrics import RouterMetrics
from .registry import Registry, Replica
from .router import (FORWARD_HEADER_EXCLUDES, _MAX_BODY, _REPLICA_PATH,
                     _STREAM_PATH, EdgeCache, aggregate_metrics_text,
                     autoscaler_document, ensure_stream_id,
                     merged_streams, readyz_document, replica_operation)

_logger = logging.getLogger(__name__)

__all__ = ["EvLoopRouterServer"]

_RECV = 65536                 # one recv() granule (and streaming chunk)
_MAX_HEAD = 65536             # request head cap (threads: 414 on the line)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            408: "Request Timeout", 414: "URI Too Long",
            501: "Not Implemented", 502: "Bad Gateway",
            503: "Service Unavailable"}

# deadline kinds (what to do when a connection's deadline fires)
_DL_IDLE = 0        # quiet between requests: close, count idle_closed
_DL_HEAD = 1        # mid-head slowloris: 408 + close, count idle_closed
_DL_BODY = 2        # stalled body sender: close, count idle_closed
_DL_UPSTREAM = 3    # upstream round trip too slow: transport error
_DL_DRAIN = 4       # full relay buffer not draining: shed (overflow)


class _TimerWheel:
    """Hashed timer wheel with lazy re-file.

    ``conn.deadline`` is the truth; wheel entries are hints.  ``arm``
    files a connection at its deadline's tick.  A deadline that moves
    LATER is handled lazily: the early entry fires, sees the deadline
    in the future, and re-files.  A deadline that moves EARLIER files
    an additional entry immediately (otherwise a short deadline — the
    10s header or 30s upstream one — would only fire at the stale 60s
    idle tick); ``conn.wheel_tick`` names the live entry so the stale
    later one is skipped when it fires.  O(1) arm, O(slot) advance —
    per-request deadline updates are two attribute writes on the
    steady path.
    """

    __slots__ = ("granularity", "nslots", "slots", "tick")

    def __init__(self, granularity: float = 0.25, nslots: int = 512):
        self.granularity = granularity
        self.nslots = nslots
        self.slots: List[list] = [[] for _ in range(nslots)]
        self.tick = 0          # next tick to process

    def _file(self, conn, deadline: float) -> None:
        t = max(int(deadline / self.granularity) + 1, self.tick)
        conn.wheel_tick = t
        self.slots[t % self.nslots].append((t, conn))

    def arm(self, conn, deadline: float, kind: int) -> None:
        conn.deadline = deadline
        conn.deadline_kind = kind
        if not conn.wheel_filed:
            conn.wheel_filed = True
            self._file(conn, deadline)
        elif int(deadline / self.granularity) + 1 < conn.wheel_tick:
            # moved earlier than the filed entry: file a fresh one (the
            # stale later entry no longer matches wheel_tick)
            self._file(conn, deadline)

    def disarm(self, conn) -> None:
        # lazy: the stale entry is dropped when its slot fires
        conn.deadline = 0.0

    def advance(self, now: float, expire) -> None:
        """Fire every slot up to ``now``; ``expire(conn, kind)`` runs
        for each connection whose deadline truly passed."""
        now_tick = int(now / self.granularity)
        while self.tick <= now_tick:
            slot = self.slots[self.tick % self.nslots]
            if slot:
                keep = []
                for t, conn in slot:
                    if t != self.tick:
                        keep.append((t, conn))   # a later wrap's entry
                        continue
                    if conn.wheel_tick != t:
                        continue     # superseded by an earlier re-file
                    conn.wheel_filed = False
                    if conn.closed or conn.deadline <= 0.0:
                        continue
                    if conn.deadline > now:
                        conn.wheel_filed = True
                        self._file(conn, conn.deadline)
                    else:
                        kind = conn.deadline_kind
                        # clear BEFORE firing so a duplicate entry at
                        # this tick can never expire the conn twice
                        conn.deadline = 0.0
                        expire(conn, kind)
                self.slots[self.tick % self.nslots] = keep
            self.tick += 1


class _Upstream:
    """One non-blocking keep-alive socket to a replica.

    Idle (pooled): registered for READ so a replica-side close is seen
    and the socket dropped.  Busy: attached to a client ``_Conn``, its
    READ events feed the response splice.
    """

    __slots__ = ("sock", "rid", "netloc", "rbuf", "reused", "conn",
                 "closed", "outbuf", "out_off", "t0", "mask",
                 "deadline", "deadline_kind", "wheel_filed",
                 "wheel_tick", "last_head", "last_parsed")

    def __init__(self, netloc: str, rid: str):
        host, port = netloc.rsplit(":", 1)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setblocking(False)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        err = self.sock.connect_ex((host, int(port)))
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            self.sock.close()
            raise OSError(err, "connect failed")
        self.rid = rid
        self.netloc = netloc
        self.rbuf = bytearray()       # response accumulator
        self.outbuf: List[bytes] = []  # unsent request bytes
        self.out_off = 0
        self.reused = False
        self.conn = None              # busy: owning client _Conn
        self.closed = False
        self.t0 = 0.0                 # attempt start (upstream latency)
        self.mask = 0                 # current selector interest
        # wheel bookkeeping (idle upstreams carry no deadline; the
        # owning client conn carries the in-flight one)
        self.deadline = 0.0
        self.deadline_kind = _DL_UPSTREAM
        self.wheel_filed = False
        self.wheel_tick = 0
        # steady-state response-head cache: a replica answering the
        # same request shape emits byte-identical heads (modulo a
        # once-per-second Date tick) — skip the re-parse on a hit
        self.last_head = b""
        self.last_parsed = (0, 0, False)   # (status, length, close)

    def close(self) -> None:
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass


class _Conn:
    """One accepted client connection: the splice state machine."""

    # FSM states
    HEAD, BODY, DISPATCH, RELAY = range(4)

    __slots__ = ("sock", "inbuf", "outbuf", "out_off", "out_len",
                 "state", "closed", "closing", "keep_alive", "mask",
                 "client_gone", "processing", "drain_wait",
                 # request under assembly / in flight
                 "method", "target", "path", "head_lines", "body",
                 "body_need", "t0",
                 # routing state
                 "kind", "sid", "creating", "tried", "attempts",
                 "saw_transport", "saw_shed", "resent", "replica",
                 "via_override", "u", "cache_key",
                 # response splice state
                 "resp_status", "resp_need", "resp_head_len",
                 "resp_streaming", "resp_sent_any", "resp_close",
                 "book_resolved",
                 # steady-state head cache (identical request heads on a
                 # keep-alive connection skip the parse + rebuild)
                 "head_cache", "hc_body_need", "fwd_cache",
                 # timer wheel
                 "deadline", "deadline_kind", "wheel_filed",
                 "wheel_tick")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf: List[bytes] = []
        self.out_off = 0              # offset into outbuf[0]
        self.out_len = 0              # total unflushed bytes
        self.state = _Conn.HEAD
        self.closed = False
        self.closing = False          # close once outbuf drains
        self.keep_alive = True
        self.client_gone = False      # EOF seen mid-request
        self.processing = False       # _on_client_bytes reentrancy guard
        self.drain_wait = False       # paused until outbuf drains
        self.mask = 0
        self.deadline = 0.0
        self.deadline_kind = _DL_IDLE
        self.wheel_filed = False
        self.wheel_tick = 0
        # parse products survive _reset_request: on a head-cache hit the
        # previous request's method/target/path/head_lines are reused
        self.method = ""
        self.target = ""
        self.path = ""
        self.head_lines: List[bytes] = []
        self.head_cache = b""
        self.hc_body_need = 0
        self.fwd_cache: Dict[str, bytes] = {}   # rid -> head sans CL
        self._reset_request()

    def _reset_request(self) -> None:
        self.body = bytearray()
        self.body_need = 0
        self.t0 = 0.0
        self.kind = ""                # "score" | "stream" | ""
        self.sid: Optional[str] = None
        self.creating = False
        self.tried: Set[str] = set()
        self.attempts = 0
        self.saw_transport = False
        self.saw_shed = False
        self.resent = False
        self.replica: Optional[Replica] = None
        self.via_override = False
        self.u: Optional[_Upstream] = None
        self.cache_key: Optional[str] = None   # edge-cache probe digest
        # (set only on a /score miss: the 200 relay populates under it)
        self.resp_status = 0
        self.resp_need = 0            # response body bytes still owed
        self.resp_head_len = 0        # head+CRLFCRLF bytes of the resp
        self.resp_streaming = False
        self.resp_sent_any = False
        self.resp_close = False       # upstream said Connection: close
        self.book_resolved = True     # False only while a routed
        # request is unresolved — _close_conn books it failed


def _hval(low: bytes, head: bytes, name: bytes) -> Optional[bytes]:
    """Value of header ``name`` in ``head`` (``low`` = head.lower()),
    or None.  Single-pass find — no header dict is ever built."""
    i = low.find(b"\n" + name + b":")
    if i < 0:
        return None
    j = i + 1 + len(name) + 1
    k = head.find(b"\r\n", j)
    if k < 0:
        k = head.find(b"\n", j)
        if k < 0:
            k = len(head)
    return head[j:k].strip()


class _ControlJob:
    __slots__ = ("fn", "conn", "loop")

    def __init__(self, fn, conn, loop):
        self.fn = fn
        self.conn = conn
        self.loop = loop


class _Loop:
    """One event loop: selector + listener shard + timer wheel + its own
    upstream pools.  Shares registry/metrics/config via the server."""

    def __init__(self, server: "EvLoopRouterServer",
                 listener: socket.socket):
        self.server = server
        self.registry = server.registry
        self.metrics = server.metrics
        self.listener = listener
        self.sel = selectors.DefaultSelector()
        self.wheel = _TimerWheel()
        self.conns: Set[_Conn] = set()
        self.pools: Dict[str, List[_Upstream]] = {}
        self._pool_gen = -1
        # control-plane completion channel (worker thread -> loop)
        self._done: List[Tuple[_Conn, int, bytes, str]] = []
        self._done_lock = threading.Lock()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ,
                          ("accept", None))
        self.sel.register(self._wake_r, selectors.EVENT_READ,
                          ("wake", None))
        # Date header cache (one strftime per second, as threads plane)
        self._date_second = -1
        self._date_value = ""

    # -- selector interest bookkeeping ---------------------------------
    def _set_mask(self, obj, sock: socket.socket, mask: int,
                  tag: str) -> None:
        if mask == obj.mask:
            return
        if obj.mask == 0:
            self.sel.register(sock, mask, (tag, obj))
        elif mask == 0:
            self.sel.unregister(sock)
        else:
            self.sel.modify(sock, mask, (tag, obj))
        obj.mask = mask

    # -- response construction (router-built documents only) -----------
    def _date(self, now: float) -> str:
        sec = int(now)
        if sec != self._date_second:
            self._date_second = sec
            self._date_value = time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(sec))
        return self._date_value

    def _build(self, status: int, body: bytes,
               content_type: str = "application/json",
               extra: Optional[dict] = None, close: bool = False
               ) -> bytes:
        parts = [f"HTTP/1.1 {status} {_REASONS.get(status, 'X')}\r\n"
                 f"Server: dfd-router\r\nDate: {self._date(time.time())}"
                 f"\r\nContent-Type: {content_type}\r\n"
                 f"Content-Length: {len(body)}\r\n"]
        for k, v in (extra or {}).items():
            parts.append(f"{k}: {v}\r\n")
        if close:
            parts.append("Connection: close\r\n")
        parts.append("\r\n")
        return "".join(parts).encode("latin-1") + body

    def _respond(self, c: _Conn, status: int, body: bytes,
                 content_type: str = "application/json",
                 extra: Optional[dict] = None,
                 close: bool = False) -> None:
        self.metrics.count_request(status)
        if close:
            c.keep_alive = False
        self._enqueue(c, self._build(status, body, content_type, extra,
                                     close or not c.keep_alive))

    def _json(self, c: _Conn, status: int, obj: dict,
              extra: Optional[dict] = None, close: bool = False) -> None:
        self._respond(c, status, json.dumps(obj).encode(), extra=extra,
                      close=close)

    # -- outbound splice ------------------------------------------------
    def _enqueue(self, c: _Conn, data: bytes) -> None:
        if c.closed:
            return
        c.outbuf.append(data)
        c.out_len += len(data)
        self._flush(c)

    def _flush(self, c: _Conn) -> None:
        """Optimistic writes until EAGAIN; gate WRITE interest on a
        non-empty buffer (writability-gated backpressure)."""
        before = c.out_len
        try:
            while c.outbuf:
                chunk = c.outbuf[0]
                n = c.sock.send(chunk[c.out_off:] if c.out_off
                                else chunk)
                c.out_len -= n
                c.out_off += n
                if c.out_off >= len(chunk):
                    c.outbuf.pop(0)
                    c.out_off = 0
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close_conn(c)
            return
        if c.drain_wait and c.out_len < before:
            # the reader is draining: keep the overflow-shed deadline
            # rolling — only a reader that stops making progress with
            # the buffer past its bound is ever shed
            c.deadline = time.monotonic() + self.server.idle_timeout_s
        if c.outbuf:
            self._set_mask(c, c.sock, c.mask | selectors.EVENT_WRITE,
                           "conn")
        else:
            if c.closing:
                self._close_conn(c)
                return
            if c.mask & selectors.EVENT_WRITE:
                self._set_mask(c, c.sock,
                               c.mask & ~selectors.EVENT_WRITE, "conn")
            if c.drain_wait:
                # overflow pause over: the relay buffer drained — go
                # back to serving (possibly pipelined) requests
                c.drain_wait = False
                self.wheel.arm(c, time.monotonic() +
                               self.server.idle_timeout_s, _DL_IDLE)
                if c.inbuf:
                    self._on_client_bytes(c)
                if c.closed or c.drain_wait:
                    return
                if not (c.mask & selectors.EVENT_READ):
                    self._set_mask(c, c.sock,
                                   c.mask | selectors.EVENT_READ,
                                   "conn")
            # a paused streaming upstream resumes once we drain below
            # the low-water mark
            u = c.u
            if (u is not None and c.resp_streaming and u.mask == 0
                    and not u.closed):
                self._set_mask(u, u.sock, selectors.EVENT_READ, "up")

    def _poison(self, c: _Conn) -> None:
        """Close once the (already enqueued) response flushes — or now,
        if it already has."""
        c.closing = True
        if not c.outbuf:
            self._close_conn(c)

    def _close_conn(self, c: _Conn) -> None:
        if c.closed:
            return
        c.closed = True
        if not c.book_resolved:
            # a routed request dies with its connection (client went
            # away mid-splice): still exactly one book resolution
            c.book_resolved = True
            self.metrics.failed_total.inc()
            self.metrics.latency["total"].observe(
                time.monotonic() - c.t0)
        self.conns.discard(c)
        if c.mask:
            try:
                self.sel.unregister(c.sock)
            except (KeyError, ValueError):
                pass
            c.mask = 0
        try:
            c.sock.close()
        except OSError:
            pass
        u = c.u
        if u is not None:
            # mid-request upstream: response state unknown, not
            # poolable.  The attempt is still live here (every resolved
            # attempt clears c.u first), so settle its accounting —
            # Replica.router_inflight must not stay inflated because
            # the client died mid-relay.
            c.u = None
            u.conn = None
            self._attempt_done(c, u)
            self._kill_upstream(u)

    def _finish_response(self, c: _Conn) -> None:
        """One request fully resolved and its response enqueued: go back
        to HEAD, processing pipelined leftover immediately."""
        if not c.keep_alive or c.client_gone:
            c.closing = True
            if not c.outbuf:
                self._close_conn(c)
            return
        c.state = _Conn.HEAD
        c._reset_request()
        # bounded-buffer guard: past a full relay buffer, PAUSE — stop
        # reading the next pipelined request until the buffer drains
        # (_flush resumes us).  Closing here would discard unsent
        # response bytes an actively-draining reader is still owed
        # (silent truncation booked as success); only a reader that
        # stops making progress is shed, on the _DL_DRAIN deadline.
        if c.out_len > self.server.max_buffer_bytes:
            c.drain_wait = True
            if c.mask & selectors.EVENT_READ:
                self._set_mask(c, c.sock,
                               c.mask & ~selectors.EVENT_READ, "conn")
            self.wheel.arm(c, time.monotonic() +
                           self.server.idle_timeout_s, _DL_DRAIN)
            return
        self.wheel.arm(c, time.monotonic() + self.server.idle_timeout_s,
                       _DL_IDLE)
        if c.inbuf:
            self._on_client_bytes(c)       # pipelined request already in
        elif not (c.mask & selectors.EVENT_READ):
            self._set_mask(c, c.sock, c.mask | selectors.EVENT_READ,
                           "conn")

    # -- accept / client reads ------------------------------------------
    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self.listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            c = _Conn(sock)
            self.conns.add(c)
            self._set_mask(c, sock, selectors.EVENT_READ, "conn")
            self.wheel.arm(c, time.monotonic() +
                           self.server.idle_timeout_s, _DL_IDLE)

    def _on_conn_event(self, c: _Conn, mask: int) -> None:
        if c.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._flush(c)
            if c.closed:
                return
        if mask & selectors.EVENT_READ:
            try:
                data = c.sock.recv(_RECV)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn(c)
                return
            if not data:
                if c.state in (_Conn.HEAD, _Conn.BODY):
                    # no request in flight: plain disconnect
                    self._close_conn(c)
                    return
                # EOF with a routed request in flight: let the upstream
                # resolve so the books stay exact, then close
                c.client_gone = True
                self._set_mask(c, c.sock,
                               c.mask & ~selectors.EVENT_READ, "conn")
                return
            c.inbuf += data
            if c.state in (_Conn.HEAD, _Conn.BODY):
                self._on_client_bytes(c)
            elif len(c.inbuf) > self.server.max_buffer_bytes:
                # a request is in flight: pipelined bytes accumulate in
                # inbuf; stop reading past a full buffer (resumed when
                # the in-flight response finishes)
                self._set_mask(c, c.sock,
                               c.mask & ~selectors.EVENT_READ, "conn")

    def _on_client_bytes(self, c: _Conn) -> None:
        """Drive the FSM off whatever sits in ``inbuf``.  Loops so a
        pipelined burst is consumed without extra selector turns; the
        ``processing`` guard makes nested calls (a synchronous dispatch
        finishing its response) fold into this loop instead of recursing
        once per pipelined request."""
        if c.processing:
            return
        c.processing = True
        try:
            self._client_fsm(c)
        finally:
            c.processing = False

    def _client_fsm(self, c: _Conn) -> None:
        while not c.closed and not c.drain_wait:
            if c.state == _Conn.HEAD:
                idx = c.inbuf.find(b"\r\n\r\n")
                if idx < 0:
                    if len(c.inbuf) > _MAX_HEAD:
                        self._respond(c, 414, b'{"error": "head too '
                                      b'large"}', close=True)
                        self._poison(c)
                        return
                    if c.inbuf and c.deadline_kind != _DL_HEAD:
                        # first head byte: arm the slowloris deadline
                        # ONCE — trickling more bytes must not push it
                        self.wheel.arm(
                            c, time.monotonic() +
                            self.server.header_timeout_s, _DL_HEAD)
                    return
                head = bytes(c.inbuf[:idx + 4])
                del c.inbuf[:idx + 4]
                if head == c.head_cache:
                    # steady state: byte-identical head — reuse last
                    # parse (method/target/path/head_lines persist)
                    c.body_need = c.hc_body_need
                else:
                    if not self._parse_head(c, head):
                        return
                    c.head_cache = head
                    c.hc_body_need = c.body_need
                    c.fwd_cache.clear()
                c.state = _Conn.BODY
            if c.state == _Conn.BODY:
                if c.body_need > 0 and c.inbuf:
                    take = min(c.body_need, len(c.inbuf))
                    c.body += c.inbuf[:take]
                    del c.inbuf[:take]
                    c.body_need -= take
                if c.body_need > 0:
                    # wait for more client bytes; rolling deadline —
                    # progress resets it (the threads plane's per-recv
                    # socket timeout semantics)
                    self.wheel.arm(c, time.monotonic() +
                                   self.server.idle_timeout_s, _DL_BODY)
                    return
                c.state = _Conn.DISPATCH
                # READ stays armed: pipelined bytes accumulate in inbuf
                # (bounded in _on_conn_event) with no epoll churn
                self.wheel.disarm(c)
                self._dispatch(c)
                if c.state != _Conn.HEAD:
                    return            # routed: resolves off an event
                continue              # synchronous resolve: next request
            if c.state != _Conn.HEAD:
                return

    def _parse_head(self, c: _Conn, head: bytes) -> bool:
        eol = head.find(b"\r\n")
        line = head[:eol]
        parts = line.split()
        if len(parts) != 3:
            self._respond(c, 400, b'{"error": "malformed request '
                          b'line"}', close=True)
            self._poison(c)
            return False
        method = parts[0].decode("latin-1")
        c.method = method
        c.target = parts[1].decode("latin-1")
        c.path = c.target.split("?", 1)[0]
        version = parts[2]
        low = head.lower()
        conn_tok = _hval(low, head, b"connection") or b""
        if version == b"HTTP/1.0":
            c.keep_alive = conn_tok.lower() == b"keep-alive"
        else:
            c.keep_alive = conn_tok.lower() != b"close"
        if method not in ("GET", "POST", "DELETE"):
            self._json(c, 501,
                       {"error": f"Unsupported method ({method!r})"},
                       close=True)
            self._poison(c)
            return False
        if _hval(low, head, b"transfer-encoding") is not None:
            # drain-or-poison discipline: chunked framing is never
            # spliced — reject and poison the connection
            self._json(c, 400, {"error": "unreadable/oversize body"},
                       close=True)
            self._poison(c)
            return False
        cl = _hval(low, head, b"content-length")
        try:
            length = int(cl) if cl is not None else 0
        except ValueError:
            length = -1
        if not 0 <= length <= _MAX_BODY:
            self._json(c, 400, {"error": "unreadable/oversize body"},
                       close=True)
            self._poison(c)
            return False
        c.body_need = length
        # forwardable header lines, verbatim (hop-by-hop excluded)
        c.head_lines = []
        for hl in head[eol + 2:-4].split(b"\r\n"):
            key = hl.split(b":", 1)[0].strip().lower()
            if key and key.decode("latin-1") not in \
                    FORWARD_HEADER_EXCLUDES:
                c.head_lines.append(hl)
        return True

    # -- dispatch --------------------------------------------------------
    def _dispatch(self, c: _Conn) -> None:
        method, path = c.method, c.path
        if method == "POST":
            if path.startswith("/replicas/"):
                m = _REPLICA_PATH.match(path)
                if m:
                    srv = self.server
                    rid, op = m.group(1), m.group(2) or ""
                    self._control(c, lambda: replica_operation(
                        self.registry, self.metrics, srv._drain_lock,
                        rid, op, srv.migrate_timeout_s))
                    return
            return self._proxy(c)
        if method == "GET":
            if path == "/healthz":
                self._respond(c, 200, b"ok\n", "text/plain")
                return self._finish_response(c)
            if path == "/readyz":
                status, body = readyz_document(self.registry,
                                               self.metrics)
                self._respond(c, status, body)
                return self._finish_response(c)
            if path == "/metrics":
                self._respond(c, 200, aggregate_metrics_text(
                    self.registry, self.metrics).encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
                return self._finish_response(c)
            if path == "/replicas":
                self._json(c, 200, {r.id: r.summary()
                                    for r in self.registry.all()})
                return self._finish_response(c)
            if path == "/autoscaler":
                status, body = autoscaler_document(
                    getattr(self.server, "autoscaler", None))
                self._respond(c, status, body)
                return self._finish_response(c)
            if path == "/streams":
                srv = self.server
                self._control(c, lambda: (200, merged_streams(
                    self.registry, srv.upstream_timeout_s)))
                return
        self._proxy(c)

    def _control(self, c: _Conn, fn) -> None:
        """Run a blocking control verb on the worker thread; the
        completion is posted back through the wake socketpair."""
        self.server._control_q.put(_ControlJob(fn, c, self))

    def control_done(self, c: _Conn, status: int, body: bytes) -> None:
        if c.closed:
            return
        self._respond(c, status, body)
        self._finish_response(c)

    # -- proxy path: exactly one book per routed request ----------------
    def _proxy(self, c: _Conn) -> None:
        method, path = c.method, c.path
        if path == "/score":
            m = None
        else:
            m = _STREAM_PATH.match(path)
            if not ((path == "/streams" and method == "POST") or m):
                self._json(c, 404, {"error": f"no route {path!r}"})
                return self._finish_response(c)
        # client-error rejections resolve BEFORE the books (parity with
        # the threads plane: routed only counts placeable requests)
        if m and m.group(2) == "/migrate" and method == "POST":
            self._json(c, 400, {"error": "migrate via POST "
                                         "/replicas/<id>/drain"})
            return self._finish_response(c)
        if path == "/streams/restore" and method == "POST":
            self._json(c, 400, {"error": "restore via POST "
                                         "/replicas/<id>/drain (a "
                                         "restore bypassing the router "
                                         "desyncs stream affinity)"})
            return self._finish_response(c)
        body = bytes(c.body)
        if method == "POST" and path == "/streams":
            sid, body = ensure_stream_id(body)
            if sid is None:
                self._json(c, 400, {"error": "body must be empty or a "
                                             "JSON object"})
                return self._finish_response(c)
            c.sid = sid
            c.creating = True
            c.body = bytearray(body)
        c.t0 = time.monotonic()
        self.metrics.routed_total.inc()
        c.book_resolved = False
        c.state = _Conn.RELAY
        if path == "/score":
            c.kind = "score"
            cache = self.server.edge_cache
            if cache is not None:
                ct = b""
                for hl in c.head_lines:
                    if hl[:13].lower() == b"content-type:":
                        ct = hl[13:].strip()
                        break
                c.cache_key = EdgeCache.request_key(
                    method, c.target, ct.decode("latin-1"), body)
                hit = cache.get(c.cache_key)
                if hit is not None:
                    # edge verdict-cache resolution: one book, no
                    # replica touched (parity with the threads plane)
                    self.metrics.cache_hit_total.inc()
                    c.book_resolved = True
                    self._respond(c, hit[0], hit[2], hit[1])
                    if c.closed:
                        return
                    return self._resolve(c)
            self._next_attempt(c)
        else:
            c.kind = "stream"
            if not c.creating:
                c.sid = m.group(1)
            self._route_stream(c)

    def _resolve(self, c: _Conn) -> None:
        """Common tail of every book resolution: total latency."""
        self.metrics.latency["total"].observe(time.monotonic() - c.t0)
        self._finish_response(c)

    def _shed(self, c: _Conn, note: str,
              extra: Optional[dict] = None) -> None:
        self.metrics.shed_total.inc()
        c.book_resolved = True
        ra = self.server.shed_retry_after()
        self._json(c, 503, {"error": note, **(extra or {})},
                   extra={"Retry-After": max(1, round(ra))})
        self._resolve(c)

    def _fail(self, c: _Conn, note: str) -> None:
        self.metrics.failed_total.inc()
        c.book_resolved = True
        self._json(c, 502, {"error": note})
        self._resolve(c)

    def _route_stream(self, c: _Conn) -> None:
        if c.creating:
            # a NEW stream re-using a migrated-then-closed id binds to
            # its ring home, not the stale migration target
            self.registry.clear_override(c.sid)
        r, via_override = self.registry.pick_stream_fast(c.sid)
        if r is None:
            return self._shed(c, "no replicas registered")
        if not (r.healthy and r.ready) or (r.draining and c.creating):
            return self._shed(c, f"stream home replica {r.id} "
                                 f"unavailable", {"replica": r.id})
        c.via_override = via_override
        self._attach_upstream(c, r)

    def _next_attempt(self, c: _Conn) -> None:
        """Stateless shed-aware failover: the async unrolling of the
        threads plane's ``_route_stateless`` loop."""
        srv = self.server
        while c.attempts < 1 + srv.route_retries:
            r = self.registry.pick_stateless_fast(exclude=c.tried)
            if r is None:
                break
            c.tried.add(r.id)
            if c.attempts:
                self.metrics.retries_total.inc()
            c.attempts += 1
            self._attach_upstream(c, r)
            return
        if c.saw_transport and not c.saw_shed:
            return self._fail(c, "replica transport errors exhausted "
                                 "the failover budget")
        self._shed(c, "fleet overloaded or no eligible replica, retry "
                      "later", {"tried": sorted(c.tried)})

    # -- upstream pool + splice -----------------------------------------
    def _pool_acquire(self, r: Replica) -> _Upstream:
        lst = self.pools.get(r.id)
        while lst:
            u = lst.pop()
            if u.closed:
                continue
            # READ stays registered across pool/attach transitions —
            # zero epoll churn on the steady-state path
            u.reused = True
            u.rbuf.clear()
            return u
        return _Upstream(r.netloc, r.id)

    def _pool_release(self, c: _Conn, u: _Upstream) -> None:
        u.conn = None
        c.u = None
        if u.closed or c.resp_close:
            self._kill_upstream(u)
            return
        u.rbuf.clear()
        # idle pooled sockets stay readable so replica-side closes are
        # seen immediately (EOF -> drop, never handed to a request)
        self._set_mask(u, u.sock, selectors.EVENT_READ, "up")
        self.pools.setdefault(u.rid, []).append(u)

    def _kill_upstream(self, u: _Upstream) -> None:
        if u.mask:
            try:
                self.sel.unregister(u.sock)
            except (KeyError, ValueError):
                pass
            u.mask = 0
        u.close()

    def _prune_pools(self) -> None:
        gen = self.registry.generation
        if gen == self._pool_gen:
            return
        self._pool_gen = gen
        live = {r.id: r for r in self.registry.view()}
        for rid in list(self.pools):
            rep = live.get(rid)
            if rep is None or not rep.healthy:
                for u in self.pools.pop(rid):
                    if not u.closed:
                        self._kill_upstream(u)
                        self.metrics.upstream_pool_closed_total.inc()

    def _forward_head(self, c: _Conn, r: Replica) -> bytes:
        # cached per (connection head, replica): only the
        # Content-Length varies (the body may be rewritten, e.g. stream
        # id injection), so the prefix is reusable verbatim
        prefix = c.fwd_cache.get(r.id)
        if prefix is None:
            parts = [f"{c.method} {c.target} HTTP/1.1\r\n"
                     f"Host: {r.netloc}\r\n".encode("latin-1")]
            for hl in c.head_lines:
                parts.append(hl + b"\r\n")
            prefix = b"".join(parts)
            c.fwd_cache[r.id] = prefix
        return prefix + b"Content-Length: %d\r\n\r\n" % len(c.body)

    def _attach_upstream(self, c: _Conn, r: Replica) -> None:
        try:
            u = self._pool_acquire(r)
        except OSError:
            return self._attempt_failed(c, r, timeout=False,
                                        connect=True)
        u.conn = c
        c.u = u
        c.replica = r
        c.resp_status = 0
        c.resp_need = 0
        c.resp_streaming = False
        c.resp_sent_any = False
        c.resp_close = False
        u.rbuf.clear()
        # head + body as ONE buffer: one send() on the fast path
        u.outbuf = [self._forward_head(c, r) + bytes(c.body)]
        u.out_off = 0
        u.t0 = time.monotonic()
        # lock-free inflight accounting (single loop thread per shard;
        # a lost update across shards skews depth by one, not books)
        r.router_inflight += 1
        self.wheel.arm(c, u.t0 + self.server.upstream_timeout_s,
                       _DL_UPSTREAM)
        self._pump_upstream_out(u)
        if not u.closed and not (u.mask & selectors.EVENT_READ):
            # fresh socket (connect in flight): register now; pooled
            # sockets kept READ across the attach
            self._set_mask(
                u, u.sock, selectors.EVENT_READ |
                (selectors.EVENT_WRITE if u.outbuf else 0), "up")

    def _attempt_done(self, c: _Conn, u: _Upstream) -> None:
        """Per-attempt accounting shared by success and error paths."""
        r = c.replica
        if r is not None:
            r.router_inflight = max(0, r.router_inflight - 1)
        self.metrics.latency["upstream"].observe(
            time.monotonic() - u.t0)
        self.wheel.disarm(c)

    def _pump_upstream_out(self, u: _Upstream) -> None:
        try:
            while u.outbuf:
                chunk = u.outbuf[0]
                n = u.sock.send(chunk[u.out_off:] if u.out_off
                                else chunk)
                u.out_off += n
                if u.out_off >= len(chunk):
                    u.outbuf.pop(0)
                    u.out_off = 0
        except (BlockingIOError, InterruptedError):
            if u.mask and not (u.mask & selectors.EVENT_WRITE):
                self._set_mask(u, u.sock, u.mask |
                               selectors.EVENT_WRITE, "up")
            return
        except OSError:
            c = u.conn
            if c is not None:
                self._upstream_error(c, timeout=False)
            else:
                self._kill_upstream(u)
            return
        if not u.outbuf and u.mask & selectors.EVENT_WRITE:
            self._set_mask(u, u.sock, selectors.EVENT_READ, "up")

    def _on_upstream_event(self, u: _Upstream, mask: int) -> None:
        if u.closed:
            return
        c = u.conn
        if c is None:
            # idle pooled socket: the only legitimate event is a
            # replica-side close — anything arriving means the socket
            # is no longer trustworthy for splicing, so drop it
            try:
                u.sock.recv(_RECV)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                pass
            self._kill_upstream(u)
            return
        if mask & selectors.EVENT_WRITE:
            self._pump_upstream_out(u)
            if u.closed:
                return
        if mask & selectors.EVENT_READ:
            try:
                data = u.sock.recv(_RECV)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._upstream_error(c, timeout=False)
                return
            if not data:
                self._upstream_error(c, timeout=False)
                return
            self._on_upstream_bytes(c, u, data)

    def _upstream_error(self, c: _Conn, timeout: bool) -> None:
        """Transport failure (EOF / reset / deadline) on the attempt's
        upstream.  Mirrors the threads plane's retry-once-on-reused
        rule: an idled-out keep-alive socket (EOF class, nothing
        relayed yet) retries the SAME replica once on a fresh socket; a
        timeout never retries (the replica may have the request — a
        resend would double-deliver)."""
        u = c.u
        r = c.replica
        self._attempt_done(c, u)
        c.u = None
        u.conn = None
        self._kill_upstream(u)
        if (u.reused and not timeout and not c.resp_sent_any
                and not c.resent and r is not None):
            c.resent = True
            self._attach_upstream(c, r)
            return
        self._attempt_failed(c, r, timeout=timeout, connect=False)

    def _attempt_failed(self, c: _Conn, r: Optional[Replica],
                        timeout: bool, connect: bool) -> None:
        rid = r.id if r is not None else "?"
        if c.resp_sent_any:
            # torn splice: bytes already reached the client — no
            # failover possible; exactly one book (failed) and close
            _logger.warning("replica %s: upstream tore mid-stream on "
                            "%s", rid, c.target)
            self.metrics.failed_total.inc()
            c.book_resolved = True
            self.metrics.latency["total"].observe(
                time.monotonic() - c.t0)
            self._close_conn(c)
            return
        if c.kind == "score":
            c.saw_transport = True
            c.resent = False
            _logger.warning("replica %s: transport error on %s "
                            "(failing over)", rid, c.target)
            self._next_attempt(c)
            return
        self._fail(c, f"stream home replica {rid} transport error")

    def _on_upstream_bytes(self, c: _Conn, u: _Upstream,
                           data: bytes) -> None:
        # refresh the round-trip deadline on progress (the threads
        # plane's per-recv socket timeout semantics)
        c.deadline = time.monotonic() + self.server.upstream_timeout_s
        if c.resp_streaming:
            if len(data) > c.resp_need:
                # overrun: bytes past Content-Length (e.g. a pipelined
                # next response on the keep-alive socket) must never be
                # spliced into the client's stream — and the socket's
                # framing is no longer trustworthy, so don't pool it
                data = data[:c.resp_need]
                c.resp_close = True
            c.resp_need -= len(data)
            self._enqueue(c, data)
            if c.closed:
                return
            if c.resp_need <= 0:
                self._relay_complete(c, u)
            elif c.out_len > self.server.max_buffer_bytes:
                # backpressure: stop reading the upstream until the
                # client drains below the mark (resumed in _flush)
                self._set_mask(u, u.sock, 0, "up")
            return
        u.rbuf += data
        if c.resp_status == 0:
            idx = u.rbuf.find(b"\r\n\r\n")
            if idx < 0:
                if len(u.rbuf) > _MAX_HEAD:
                    self._upstream_error(c, timeout=False)
                return
            head = bytes(u.rbuf[:idx + 4])
            if head == u.last_head:
                # steady state: byte-identical response head (modulo
                # the once-per-second Date tick) — skip the re-parse
                status, length, rclose = u.last_parsed
            else:
                low = head.lower()
                try:
                    status = int(head[9:12])
                except ValueError:
                    self._upstream_error(c, timeout=False)
                    return
                cl = _hval(low, head, b"content-length")
                try:
                    length = int(cl) if cl is not None else 0
                except ValueError:
                    self._upstream_error(c, timeout=False)
                    return
                rclose = (_hval(low, head, b"connection") or
                          b"").lower() == b"close"
                u.last_head = head
                u.last_parsed = (status, length, rclose)
            # shed responses (429/503 on /score) stay buffered however
            # large: the failover path needs the whole document
            c.resp_status = status
            c.resp_need = length
            c.resp_head_len = idx + 4
            c.resp_close = rclose
            if (idx + 4 + length > self.server.max_buffer_bytes
                    and status not in (429, 503)):
                # streaming splice: forward verbatim, book at the end
                c.resp_streaming = True
                c.resp_sent_any = True
                full = idx + 4 + length
                if len(u.rbuf) > full:
                    # overrun past Content-Length: clamp, don't pool
                    chunk = bytes(u.rbuf[:full])
                    c.resp_close = True
                else:
                    chunk = bytes(u.rbuf)
                c.resp_need = full - len(chunk)
                self._enqueue(c, chunk)
                u.rbuf.clear()
                if c.closed:
                    return
                if c.resp_need <= 0:
                    self._relay_complete(c, u)
                return
        total = c.resp_head_len + c.resp_need
        if len(u.rbuf) >= total:
            if len(u.rbuf) > total:
                # trailing bytes past the framed response: the socket
                # can't be trusted for reuse (clamped by the slice)
                c.resp_close = True
            self._buffered_response(c, u, total)

    def _buffered_response(self, c: _Conn, u: _Upstream,
                           total: int) -> None:
        status = c.resp_status
        raw = bytes(u.rbuf[:total])
        self._attempt_done(c, u)
        r = c.replica
        if c.kind == "score" and status in (429, 503):
            low = raw[:raw.find(b"\r\n\r\n") + 4].lower()
            ra = _hval(low, raw, b"retry-after")
            try:
                ra_s = float(ra) if ra is not None else 1.0
            except (TypeError, ValueError):
                ra_s = 1.0
            self.registry.mark_shed(u.rid, ra_s)
            c.saw_shed = True
            c.resent = False
            self._pool_release(c, u)
            self._next_attempt(c)
            return
        # success: relay the response bytes VERBATIM (zero
        # re-serialization), then the books — exactly one resolution
        if c.kind == "stream":
            if c.method == "DELETE" and 200 <= status < 300:
                self.registry.clear_override(c.sid)
            book = (self.metrics.migrated_total if c.via_override
                    else self.metrics.forwarded_total)
        else:
            book = self.metrics.forwarded_total
        book.inc()
        c.book_resolved = True
        self.metrics.count_forward(u.rid)
        self.metrics.count_request(status)
        if c.kind == "score" and c.cache_key is not None and status == 200:
            # populate the edge cache with the buffered body (streamed
            # responses never reach here — _relay_complete skips)
            head = raw[:c.resp_head_len]
            ct = _hval(head.lower(), head, b"content-type")
            self.server.edge_cache.put(
                c.cache_key, status,
                (ct or b"application/json").decode("latin-1"),
                raw[c.resp_head_len:])
        self._pool_release(c, u)
        self._enqueue(c, raw)
        if c.closed:
            return
        self.metrics.latency["total"].observe(time.monotonic() - c.t0)
        self._finish_response(c)

    def _relay_complete(self, c: _Conn, u: _Upstream) -> None:
        """Streamed response fully forwarded: book it now."""
        status = c.resp_status
        self._attempt_done(c, u)
        if c.kind == "stream":
            if c.method == "DELETE" and 200 <= status < 300:
                self.registry.clear_override(c.sid)
            book = (self.metrics.migrated_total if c.via_override
                    else self.metrics.forwarded_total)
        else:
            book = self.metrics.forwarded_total
        book.inc()
        c.book_resolved = True
        self.metrics.count_forward(u.rid)
        self.metrics.count_request(status)
        self._pool_release(c, u)
        self.metrics.latency["total"].observe(time.monotonic() - c.t0)
        self._finish_response(c)

    # -- deadlines -------------------------------------------------------
    def _expire(self, c, kind: int) -> None:
        if isinstance(c, _Upstream):
            return
        if kind == _DL_UPSTREAM:
            if c.u is not None:
                self._upstream_error(c, timeout=True)
            return
        if kind == _DL_DRAIN:
            # overflow shed: a full relay buffer made zero progress for
            # an entire idle window — the reader is genuinely stalled
            self.metrics.overflow_closed_total.inc()
            self._close_conn(c)
            return
        self.metrics.idle_closed_total.inc()
        if kind == _DL_HEAD:
            # slowloris: 408, then close once the response flushes
            self.metrics.count_request(408)
            self._enqueue(c, b"HTTP/1.1 408 Request Timeout\r\n"
                             b"Content-Length: 0\r\n"
                             b"Connection: close\r\n\r\n")
            c.closing = True
            if not c.outbuf:
                self._close_conn(c)
            return
        self._close_conn(c)

    # -- the loop --------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        sel = self.sel
        wheel = self.wheel
        granularity = wheel.granularity
        wheel.tick = int(time.monotonic() / granularity)
        while not stop.is_set():
            events = sel.select(granularity)
            for key, mask in events:
                tag, obj = key.data
                if tag == "conn":
                    self._on_conn_event(obj, mask)
                elif tag == "up":
                    self._on_upstream_event(obj, mask)
                elif tag == "accept":
                    self._accept()
                else:                      # wake
                    try:
                        self._wake_r.recv(4096)
                    except (BlockingIOError, InterruptedError, OSError):
                        pass
            with self._done_lock:
                done, self._done = self._done, []
            for conn, status, body, _ in done:
                self.control_done(conn, status, body)
            wheel.advance(time.monotonic(), self._expire)
            self._prune_pools()
        self.close()

    def post_completion(self, conn: _Conn, status: int,
                        body: bytes) -> None:
        """Called from the control worker thread."""
        with self._done_lock:
            self._done.append((conn, status, body, ""))
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def close(self) -> None:
        for c in list(self.conns):
            self._close_conn(c)
        for lst in self.pools.values():
            for u in lst:
                if not u.closed:
                    self._kill_upstream(u)
        self.pools.clear()
        try:
            self.sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


class EvLoopRouterServer:
    """Event-loop router server: the RouterServer surface (serve_forever
    / shutdown / server_close / server_address + fleet wiring), hot path
    on :class:`_Loop` threads instead of a thread per connection."""

    def __init__(self, addr: Tuple[str, int], registry: Registry,
                 metrics: RouterMetrics, scraper: HealthScraper, *,
                 relay_workers: int = 1,
                 route_retries: int = 2, upstream_timeout_s: float = 30.0,
                 shed_retry_after_s: float = 1.0,
                 retry_jitter_s: float = 2.0,
                 migrate_timeout_s: float = 30.0,
                 idle_timeout_s: float = 60.0,
                 header_timeout_s: float = 10.0,
                 max_buffer_bytes: int = 1 << 20,
                 edge_cache_entries: int = 0,
                 edge_cache_ttl_s: float = 2.0):
        self.registry = registry
        self.metrics = metrics
        self.scraper = scraper
        self.route_retries = max(0, int(route_retries))
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.retry_jitter_s = float(retry_jitter_s)
        self.migrate_timeout_s = float(migrate_timeout_s)
        self.idle_timeout_s = float(idle_timeout_s)
        self.header_timeout_s = float(header_timeout_s)
        self.max_buffer_bytes = int(max_buffer_bytes)
        # optional edge verdict cache, shared across loops
        # (VerdictCache is internally locked): 0 entries = off
        self.edge_cache = (
            EdgeCache(registry, edge_cache_entries, edge_cache_ttl_s,
                      max_value_bytes=self.max_buffer_bytes)
            if int(edge_cache_entries) > 0 else None)
        self.relay_workers = max(1, int(relay_workers))
        # same seeded-rng shed jitter as the threads plane (pinned
        # by the seeded-spread test run against both planes)
        self._shed_rng = random.Random(0x0F1EE7)
        self._shed_rng_lock = threading.Lock()
        self._drain_lock = threading.Lock()
        #: the control loop, attached by the runner when
        #: --autoscale is set; serves GET /autoscaler on both planes
        self.autoscaler = None
        self._stop = threading.Event()
        self._started = threading.Event()
        self._threads: List[threading.Thread] = []
        self._control_q: "queue.Queue[Optional[_ControlJob]]" = \
            queue.Queue()
        # listeners: one per worker, SO_REUSEPORT-sharded accept
        self._listeners: List[socket.socket] = []
        host, port = addr
        for i in range(self.relay_workers):
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if self.relay_workers > 1:
                ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            ls.bind((host, port))
            if port == 0:
                port = ls.getsockname()[1]
            ls.listen(256)
            ls.setblocking(False)
            self._listeners.append(ls)
        self.server_address = self._listeners[0].getsockname()
        self._loops = [_Loop(self, ls) for ls in self._listeners]

    # -- RouterServer surface -------------------------------------------
    def shed_retry_after(self) -> float:
        with self._shed_rng_lock:
            return jittered_retry_after(self.shed_retry_after_s,
                                        self.retry_jitter_s,
                                        self._shed_rng)

    def serve_forever(self, poll_interval: Optional[float] = None
                      ) -> None:
        del poll_interval            # signature parity with socketserver
        ts = [threading.Thread(target=lo.run, args=(self._stop,),
                               name=f"dfd-evloop-{i}", daemon=True)
              for i, lo in enumerate(self._loops)]
        ts.append(threading.Thread(target=self._control_worker,
                                   name="dfd-evloop-control",
                                   daemon=True))
        self._threads = ts
        for t in ts:
            t.start()
        self._started.set()
        self._stop.wait()

    def shutdown(self) -> None:
        self._stop.set()
        self._control_q.put(None)
        for lo in self._loops:
            try:
                lo._wake_w.send(b"x")     # pop the select() immediately
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []

    def server_close(self) -> None:
        self._stop.set()
        for ls in self._listeners:
            try:
                ls.close()
            except OSError:
                pass

    # -- control worker --------------------------------------------------
    def _control_worker(self) -> None:
        while True:
            job = self._control_q.get()
            if job is None or self._stop.is_set():
                return
            try:
                status, doc = job.fn()
                body = json.dumps(doc).encode()
            except Exception as e:                 # noqa: BLE001
                _logger.exception("control operation failed")
                status, body = 500, json.dumps(
                    {"error": f"control operation failed: {e!r}"}
                ).encode()
            job.loop.post_completion(job.conn, status, body)
