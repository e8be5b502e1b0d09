"""Long-lived inference server entrypoint.

Counterpart of ``deepfake_detection_tpu/runners/serve.py``: one process
keeps the model table resident on the card, captures one CUDA graph per
(model, batch bucket, channel width) before the first request, coalesces
arrival-order traffic into those buckets, sheds overload with 429, and
hot-swaps weights from a watched checkpoint dir.

Usage::

    python -m deepfake_detection_tpu_torch.runners.serve \\
        --model-path model.pth [--port 8377] [--buckets 1,4,16,64] \\
        [--batch-deadline-ms 5] [--max-queue 128] [--reload-dir ckpts/] \\
        [--wire float32|uint8] [--warmstart-dir STORE] [--device cuda]

    curl -s -X POST --data-binary @face.npy \\
        -H 'Content-Type: application/octet-stream' \\
        http://127.0.0.1:8377/score

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the same programs eagerly (the tests), and nothing falls back to it.
Checkpoints load as in ``runners/test.py`` (torch files with timm keys,
strict; ``--use-ema`` picks the EMA stream ``train/checkpoint.py``
writes); without one the server serves the seeded init.  Frames are
``.npy`` (uint8 H×W×3) or, where Pillow is installed, any image format.
``--warmstart-dir`` keeps the built kernel libraries and the capture
manifests in a store (``serving/warmstart.py``) that a fresh checkout or
process reuses: a hit skips nvcc, and every capture of a stored unit is
held to its golden-batch scores before ready.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional, Sequence

_logger = logging.getLogger(__name__)

__all__ = ["build_model", "build_engine", "build_server", "main"]


def build_model(family: str, model_path: str, *, num_classes: int,
                in_chans: int, image_size: int, use_ema: bool, name: str,
                device: str):
    """One model-table entry's module on ``device`` (eval mode) with its
    checkpoint loaded, mirroring ``runners/test.py::test_img``."""
    from ..models import create_model, load_checkpoint

    model = create_model(family, num_classes=num_classes, in_chans=in_chans,
                         img_size=image_size, device=device)
    if model_path:
        load_checkpoint(model, model_path, use_ema=use_ema)
    else:
        _logger.warning("no checkpoint for model %r: serving a seed-0 "
                        "random init (bench/demo mode)", name)
    return model.eval()


def build_engine(cfg):
    """Model table → warmed engine + micro-batcher + metrics: the device
    half every front end shares.  The primary --model is the flagship
    entry; every --models spec adds one more, all captured before
    ready."""
    t_entry = time.monotonic()
    from ..models.factory import resolve_device
    from ..serving.batcher import MicroBatcher
    from ..serving.engine import InferenceEngine
    from ..serving.metrics import ServingMetrics

    resolve_device(cfg.device)          # no card: raises, no fallback
    t_import = time.monotonic()
    _logger.info("building %s (in_chans=%d, canvas %d², dtype=%s) on %s",
                 cfg.model, cfg.in_chans, cfg.image_size, cfg.dtype,
                 cfg.device)
    model = build_model(cfg.model, cfg.model_path,
                        num_classes=cfg.num_classes, in_chans=cfg.in_chans,
                        image_size=cfg.image_size, use_ema=cfg.use_ema,
                        name=cfg.model, device=cfg.device)
    metrics = ServingMetrics(throughput_window_s=cfg.throughput_window_s)
    warmstart = None
    if cfg.warmstart_dir:
        from ..csrc import build as kernels
        from ..serving.warmstart import WarmStore
        warmstart = WarmStore(cfg.warmstart_dir)
        kernels.set_store(warmstart)        # before the first kernel
        _logger.info("warm-start store: %s", warmstart.root)
    engine = InferenceEngine(
        model, image_size=cfg.image_size, img_num=cfg.img_num,
        buckets=cfg.buckets, metrics=metrics, wire=cfg.wire,
        multi_frame=not cfg.single_frame_only,
        dtype=cfg.dtype, model_id=cfg.model, warmup=False,
        watchdog_timeout_s=cfg.watchdog_timeout_s,
        breaker_threshold=cfg.breaker_threshold,
        breaker_open_s=cfg.breaker_open_s,
        reload_drift_tol=cfg.reload_drift_tol,
        retry_jitter_s=cfg.retry_jitter_s, warmstart=warmstart,
        warm_priority=cfg.warm_priority_buckets() or None)
    specs = cfg.model_specs()
    for spec in specs:
        in_chans = 3 * spec["img_num"]
        _logger.info("adding model %r: %s (in_chans=%d, canvas %d², "
                     "dtype=%s)", spec["id"], spec["family"], in_chans,
                     spec["size"], spec["dtype"])
        extra = build_model(spec["family"], spec["path"],
                            num_classes=cfg.num_classes, in_chans=in_chans,
                            image_size=spec["size"], use_ema=cfg.use_ema,
                            name=spec["id"], device=cfg.device)
        engine.add_model(spec["id"], extra, image_size=spec["size"],
                         img_num=spec["img_num"], dtype=spec["dtype"])
    t_params = time.monotonic()
    metrics.warmup_seconds["import"] = t_import - t_entry
    metrics.warmup_seconds["params_load"] = t_params - t_import
    _logger.info("capturing buckets %s × %d model(s)%s ...",
                 list(cfg.buckets), 1 + len(specs),
                 " (staged)" if cfg.warm_staged else "")
    engine.warmup(staged=cfg.warm_staged)
    _logger.info("warm start report: %s", json.dumps(engine.warm_report()))
    if engine.chaos.active:
        _logger.warning("DFD_CHAOS active: %s", sorted(engine.chaos.points))
    cache = None
    if int(cfg.cache_entries) > 0:
        from ..cache import VerdictCache
        cache = VerdictCache(cfg.cache_entries, cfg.cache_ttl_s,
                             near_dup=cfg.cache_near_dup,
                             near_radius=cfg.cache_near_radius,
                             on_expired=metrics.cache_expired_total.inc,
                             on_evicted=metrics.cache_evicted_total.inc)
        engine.verdict_cache = cache
        _logger.info("verdict cache: %d entries, ttl %.0fs%s",
                     cfg.cache_entries, cfg.cache_ttl_s,
                     (f", near-dup radius {cfg.cache_near_radius}"
                      if cfg.cache_near_dup else ""))
    batcher = MicroBatcher(max_batch=cfg.max_batch_size,
                           deadline_ms=cfg.batch_deadline_ms,
                           max_queue=cfg.max_queue, metrics=metrics,
                           retry_jitter_s=cfg.retry_jitter_s,
                           cache=cache)
    if cfg.reload_dir:
        engine.start_reload_watcher(cfg.reload_dir,
                                    interval_s=cfg.reload_interval_s,
                                    use_ema=cfg.use_ema)
        _logger.info("hot-reload watcher on %s (every %.1fs)",
                     cfg.reload_dir, cfg.reload_interval_s)
    for spec in specs:
        if spec["reload"]:
            engine.start_reload_watcher(spec["reload"],
                                        interval_s=cfg.reload_interval_s,
                                        use_ema=cfg.use_ema,
                                        model_id=spec["id"])
            _logger.info("hot-reload watcher for model %r on %s",
                         spec["id"], spec["reload"])
    return engine, batcher, metrics


def build_server(cfg):
    """Model table → engine → batcher → (optional cascade) → HTTP server;
    returns the (not yet started) :class:`ServingServer` with
    engine/batcher attached."""
    from ..serving.http import make_server

    engine, batcher, metrics = build_engine(cfg)
    cascade = None
    if cfg.cascade:
        from ..serving.cascade import CascadeRouter
        cascade = CascadeRouter(
            batcher, metrics, student_id=cfg.cascade,
            flagship_id=engine.default_model_id,
            low=cfg.cascade_low, high=cfg.cascade_high,
            timeout_s=cfg.request_timeout_ms / 1000.0)
        _logger.info("cascade: student %r triages, suspect band "
                     "[%.3f, %.3f] escalates to %r", cfg.cascade,
                     cfg.cascade_low, cfg.cascade_high,
                     engine.default_model_id)
    return make_server(cfg.host, cfg.port, engine, batcher, metrics,
                       request_timeout_s=cfg.request_timeout_ms / 1000.0,
                       cascade=cascade)


def main(argv: Optional[Sequence[str]] = None) -> None:
    t_main = time.time()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    # many handler threads + the engine share few cores; the default 5 ms
    # GIL switch interval convoys tail latency badly under load
    sys.setswitchinterval(0.002)
    from ..serving.config import ServeConfig
    cfg = ServeConfig.from_args(argv)
    server = build_server(cfg)
    # spawn/ready stage walls: a parent stamps DFD_SPAWN_T at fork so the
    # breakdown starts at the true spawn; a bare launch starts at main()
    try:
        spawn_t = float(os.environ.get("DFD_SPAWN_T", "") or t_main)
    except ValueError:
        spawn_t = t_main
    m = server.engine.metrics
    m.warmup_seconds["spawn"] = max(0.0, t_main - spawn_t)
    m.warmup_seconds["ready"] = max(0.0, time.time() - spawn_t)
    server.engine.start(server.batcher)

    stop = threading.Event()

    def _sig(signum, frame):
        _logger.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    host, port = server.server_address[:2]
    _logger.info("serving on http://%s:%d (POST /score, GET /healthz "
                 "/readyz /metrics)", host, port)
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
        server.engine.stop()
        server.batcher.close()
        server.server_close()
        _logger.info("bye")


if __name__ == "__main__":
    main(sys.argv[1:])
