"""Trainer metrics endpoint: stdlib HTTP serving Prometheus text + health.

A copy of ``deepfake_detection_tpu/obs/server.py`` (standard library
only).  The training sibling of serving/http.py's ``GET /metrics``: a
``ThreadingHTTPServer`` on ``--metrics-port`` rendering the
:class:`~deepfake_detection_tpu_torch.obs.telemetry.TrainTelemetry` registry
through the shared :mod:`..utils.prometheus` renderer.  A scrape costs a
registry snapshot on the HTTP thread — the train loop is never blocked
(registry mutations take the same short lock, microseconds).

Endpoints:

* ``GET /metrics`` — Prometheus text format (the full train catalog).
* ``GET /healthz`` — 200 while the process serves; body carries the
  current loop position gauge so ``curl`` alone answers "is it moving".
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

_logger = logging.getLogger(__name__)

__all__ = ["MetricsServer", "start_metrics_server"]


class MetricsServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], telemetry):
        super().__init__(addr, _Handler)
        self.telemetry = telemetry

    @property
    def port(self) -> int:
        return self.server_address[1]


class _Handler(BaseHTTPRequestHandler):
    server: MetricsServer               # typing aid

    def log_message(self, fmt, *args):  # BaseHTTP logs to stderr by default
        _logger.debug("%s " + fmt, self.address_string(), *args)

    def _respond(self, status: int, body: bytes,
                 content_type: str = "text/plain") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:           # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            text = self.server.telemetry.render_prometheus()
            self._respond(200, text.encode(),
                          "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            snap = self.server.telemetry.snapshot()
            g = snap["gauges"]
            body = (f"ok epoch={g.get('epoch', 0):.0f} "
                    f"update={g.get('update', 0):.0f}\n")
            self._respond(200, body.encode())
        else:
            self._respond(404, f"no route {path!r}\n".encode())


def start_metrics_server(telemetry, host: str = "0.0.0.0",
                         port: int = 0) -> MetricsServer:
    """Bind, start serving on a daemon thread, return the server (its
    ``.port`` is the bound port — pass 0 for an ephemeral one in tests).
    Stop with ``server.shutdown(); server.server_close()``."""
    server = MetricsServer((host, port), telemetry)
    t = threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.2},
                         name="dfd-train-metrics", daemon=True)
    t.start()
    _logger.info("trainer metrics endpoint on %s:%d (/metrics, /healthz)",
                 host, server.port)
    return server
