"""Streaming-video scoring server entrypoint.

Counterpart of ``deepfake_detection_tpu/runners/stream.py``.  Where
``runners/serve.py`` answers one request with one score, this runner keeps
whole *streams* alive: chunked frame ingest → face localization +
greedy-IoU tracking → per-track temporal windows of ``img_num`` distinct
frames → the SAME serving engine (one CUDA graph per model, bucket and
channel width, captured before ready) → EMA + hysteresis verdict state
machines emitting schema-versioned events.  The device half is
``runners/serve.py``'s ``build_engine`` verbatim — fixed buckets, no
capture after ready, load shedding — so a stream mix can never capture
anew or starve the engine.

Usage::

    python -m deepfake_detection_tpu_torch.runners.stream \\
        --model-path model.pth [--port 8378] [--img-num 4] \\
        [--window-hop 4] [--fake-enter 0.8] [--localizer full_frame] \\
        [--state-dir DIR] [--device cuda]

    curl -s -X POST http://127.0.0.1:8378/streams          # open
    curl -s -X POST --data-binary @frames.rgb \\
        -H 'Content-Type: application/x-dfd-raw' \\
        -H 'X-Frame-Width: 640' -H 'X-Frame-Height: 480' \\
        http://127.0.0.1:8378/streams/<id>/frames          # push + poll
    curl -s http://127.0.0.1:8378/streams/<id>             # status
    curl -s -X DELETE http://127.0.0.1:8378/streams/<id>   # close

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the same programs eagerly (the tests), and nothing falls back to it.
Encoded frames (JPEG chunks, MJPEG multipart, ``image/jpeg``) decode with
the port's own JPEG decoder; other ``image/*`` formats need Pillow, and
without it such a chunk answers 501 (the raw wire above still works).
Window scores on the default ``--wire float32`` are bitwise the port CLI's
``runners/test.py --clip`` on the same frames
(``tests/test_torch_streaming.py`` pins it).
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
import time
from typing import Optional, Sequence

_logger = logging.getLogger(__name__)

__all__ = ["build_stream_server", "main"]


def build_stream_server(cfg):
    """Wire engine + batcher + dispatcher + session manager + HTTP server;
    returns the (not yet started) :class:`StreamServer`."""
    from ..streaming.ingest import StreamManager, make_stream_server
    from ..streaming.metrics import StreamingMetrics
    from ..streaming.windows import WindowDispatcher
    from .serve import build_engine

    engine, batcher, serving_metrics = build_engine(cfg)
    metrics = StreamingMetrics()
    manager_box = []

    def on_result(job, scores, error):
        manager_box[0].on_result(job, scores, error)

    def on_drop(job, reason):
        manager_box[0].on_drop(job, reason)

    dispatcher = WindowDispatcher(
        batcher, max_pending=cfg.max_inflight_windows,
        request_timeout_s=cfg.request_timeout_ms / 1000.0,
        on_result=on_result, on_drop=on_drop)
    manager = StreamManager(cfg, dispatcher, metrics,
                            image_size=cfg.image_size, wire=cfg.wire)
    manager_box.append(manager)
    server = make_stream_server(cfg.host, cfg.port, manager, engine,
                                serving_metrics, metrics)
    server.batcher = batcher
    server.dispatcher = dispatcher
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    # the serving runner's GIL-switch tuning: many ingest threads + the
    # engine share few cores
    sys.setswitchinterval(0.002)
    from ..serving.config import StreamConfig
    cfg = StreamConfig.from_args(argv)
    server = build_stream_server(cfg)
    if cfg.state_dir:
        # resume sessions a previous instance snapshotted on its way down
        # — BEFORE traffic starts, so the first chunk of a resumed stream
        # continues its verdict machines instead of resetting them
        restored = server.manager.restore_state(cfg.state_dir)
        if restored:
            _logger.info("restored %d stream session(s) from %s",
                         restored, cfg.state_dir)
    server.engine.start(server.batcher)
    server.dispatcher.start()
    server.manager.start_evictor()

    stop = threading.Event()

    def _sig(signum, frame):
        _logger.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    host, port = server.server_address[:2]
    _logger.info(
        "streaming on http://%s:%d (POST /streams, POST|GET|DELETE "
        "/streams/<id>[/frames], GET /healthz /readyz /metrics) — "
        "localizer=%s img_num=%d hop=%d wire=%s device=%s", host, port,
        cfg.localizer, cfg.img_num,
        cfg.window_hop or cfg.img_num * cfg.window_stride, cfg.wire,
        cfg.device)
    t = threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.1}, daemon=True)
    t.start()
    try:
        # the handler sets ``stop`` in this thread: never wait on it here,
        # or a signal landing while ``wait`` holds the event's lock
        # deadlocks the process (``set`` takes the same lock)
        while not stop.is_set():
            time.sleep(0.5)
    finally:
        server.shutdown()
        # quiesce result delivery BEFORE snapshotting: a window score
        # folding in after its session was serialized would desync the
        # snapshot from the event log (the snapshot books in-flight
        # windows dropped — nothing may score behind its back)
        server.dispatcher.stop()
        if cfg.state_dir:
            # snapshot BEFORE the manager closes sessions: a SIGTERM
            # bounce must resume these verdict streams, not reset them
            server.manager.save_state(cfg.state_dir)
        server.manager.shutdown()
        server.engine.stop()
        server.batcher.close()
        server.server_close()
        _logger.info("bye")


if __name__ == "__main__":
    main(sys.argv[1:])
