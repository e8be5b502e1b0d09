"""Fleet router entrypoint: N shared-nothing replicas behind one
routing tier.

Where ``runners/serve.py`` is ONE process (and therefore one
interpreter lock's worth of HTTP, decode and canvas host work: ~70
clips/s at 32 clients on an H100 whose device runs ~115, PERF.md §5),
this runner fronts a *fleet*: stateless ``/score`` load-balances by
least queue depth, ``/streams/*`` sessions pin to replicas by consistent
hash, health is scraped off each replica's ``/readyz`` + ``/metrics``,
and draining a replica live-migrates its stream sessions.  The router
process itself NEVER imports torch — every replica is its own process
with its own engine on the card.

The counterpart of ``deepfake_detection_tpu/runners/router.py``: the
same flags (``serving/config.py`` ``RouterConfig``) and shutdown order;
spawned children run the port's ``runners/serve.py`` or
``runners/stream.py``, on the card unless ``--replica-args`` passes
``--device cpu``.

Usage::

    # attach to running replicas
    python -m deepfake_detection_tpu_torch.runners.router \
        --replicas 127.0.0.1:8377,127.0.0.1:8379 [--port 8380]

    # or spawn a local fleet of 4 serve children on the card
    python -m deepfake_detection_tpu_torch.runners.router --spawn 4 \
        --replica-args "--model-path model.pth --device cuda --wire uint8"

    curl -s -X POST --data-binary @clip.npy http://127.0.0.1:8380/score
    curl -s http://127.0.0.1:8380/replicas
    curl -s -X POST http://127.0.0.1:8380/replicas/127.0.0.1:8377/drain
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
import time
from typing import List, Optional, Sequence

_logger = logging.getLogger(__name__)

__all__ = ["build_router", "main"]


def build_router(cfg):
    """RouterConfig → (RouterServer, spawned ReplicaProcess list).

    The server is not yet started; spawned children are launched but not
    awaited (the health scraper's readiness view is the wait)."""
    from ..fleet.controller import HealthScraper, ReplicaProcess
    from ..fleet.metrics import RouterMetrics
    from ..fleet.registry import Registry
    from ..fleet.router import make_router_server

    registry = Registry(vnodes=cfg.virtual_nodes)
    spawned: List[ReplicaProcess] = []
    for _ in range(int(cfg.spawn)):
        child = ReplicaProcess(cfg.spawn_runner, 0, cfg.replica_args)
        spawned.append(child)
        r = registry.add(child.netloc, process=child)
        r.warming = True              # cold start, not down
    for url in cfg.replica_urls():
        registry.add(url)
    metrics = RouterMetrics()
    metrics.replicas_spawned_total.inc(len(spawned))
    scraper = HealthScraper(registry, metrics,
                            interval_s=cfg.scrape_interval_s,
                            fail_after=cfg.health_fail_after,
                            timeout_s=cfg.scrape_timeout_s,
                            spawn_grace_s=cfg.spawn_grace_s)
    server = make_router_server(
        cfg.host, cfg.port, registry, metrics, scraper,
        data_plane=cfg.data_plane,
        relay_workers=cfg.relay_workers,
        route_retries=cfg.route_retries,
        upstream_timeout_s=cfg.upstream_timeout_s,
        shed_retry_after_s=cfg.shed_retry_after_s,
        retry_jitter_s=cfg.retry_jitter_s,
        migrate_timeout_s=cfg.migrate_timeout_s,
        idle_timeout_s=cfg.idle_timeout_s,
        header_timeout_s=cfg.header_timeout_s,
        max_buffer_bytes=cfg.max_buffer_bytes,
        edge_cache_entries=cfg.edge_cache_entries,
        edge_cache_ttl_s=cfg.edge_cache_ttl_s)
    if int(cfg.edge_cache_entries) > 0:
        _logger.info("edge verdict cache: %d entries, ttl %.1fs "
                     "(keyed on the fleet weights-epoch)",
                     cfg.edge_cache_entries, cfg.edge_cache_ttl_s)
    if cfg.autoscale:
        from ..fleet.autoscaler import (Autoscaler, BackfillTenant,
                                        PolicyKnobs)
        tenant = None
        if cfg.backfill_tenant:
            tenant = BackfillTenant(
                manifest=cfg.backfill_tenant, out=cfg.backfill_out,
                extra_args=cfg.backfill_args,
                max_workers=cfg.backfill_max_workers, metrics=metrics,
                yield_timeout_s=cfg.backfill_yield_timeout_s)
        server.autoscaler = Autoscaler(
            registry, metrics, scraper,
            knobs=PolicyKnobs(
                slo_p99_ms=cfg.slo_p99_ms,
                min_replicas=cfg.min_replicas,
                max_replicas=cfg.max_replicas,
                up_samples=cfg.autoscale_up_samples,
                down_samples=cfg.autoscale_down_samples,
                up_cooldown_s=cfg.autoscale_up_cooldown_s,
                down_cooldown_s=cfg.autoscale_down_cooldown_s,
                shed_high=cfg.autoscale_shed_high,
                depth_high=cfg.autoscale_depth_high,
                depth_low=cfg.autoscale_depth_low),
            spawn_runner=cfg.spawn_runner,
            replica_args=cfg.replica_args,
            interval_s=cfg.autoscale_interval_s,
            tenant=tenant, trace_path=cfg.autoscale_trace,
            migrate_timeout_s=cfg.migrate_timeout_s,
            settle_timeout_s=cfg.settle_timeout_s,
            standby_replicas=cfg.standby_replicas)
        _logger.info(
            "autoscaler: slo p99 %.0fms, %d..%d replicas%s%s%s",
            cfg.slo_p99_ms, cfg.min_replicas, cfg.max_replicas,
            f", {cfg.standby_replicas} warm standby(s)"
            if int(cfg.standby_replicas) > 0 else "",
            f", backfill tenant on {cfg.backfill_tenant}"
            if tenant is not None else "",
            f", trace -> {cfg.autoscale_trace}"
            if cfg.autoscale_trace else "")
    return server, spawned


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    # the serving runner's switch-interval tuning: many proxy threads on
    # few cores convoy tail latency at the default 5 ms interval
    sys.setswitchinterval(0.002)
    from ..serving.config import RouterConfig
    cfg = RouterConfig.from_args(argv)
    server, spawned = build_router(cfg)
    server.scraper.start()
    if server.autoscaler is not None:
        server.autoscaler.start()

    stop = threading.Event()

    def _sig(signum, frame):
        _logger.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    host, port = server.server_address[:2]
    _logger.info(
        "routing on http://%s:%d [%s data plane%s] over %d replica(s): "
        "%s (POST /score, /streams/*, GET /healthz /readyz /metrics "
        "/replicas, POST /replicas/<id>/drain)", host, port,
        cfg.data_plane,
        (f", {cfg.relay_workers} shards"
         if cfg.data_plane == "evloop" and int(cfg.relay_workers) > 1
         else ""),
        len(server.registry.ids()), ", ".join(server.registry.ids()))
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
        if server.autoscaler is not None:
            # stops the control loop AND yields the backfill tenant's
            # workers (SIGTERM -> exit-75 lease release)
            server.autoscaler.stop()
        server.scraper.stop()
        # the autoscaler may have spawned children past the launch set —
        # the registry's process-attached replicas are the whole truth
        children = {id(c): c for c in spawned}
        for r in server.registry.all():
            if r.process is not None:
                children.setdefault(id(r.process), r.process)
        if cfg.drain_on_exit and children:
            from ..fleet.migrate import drain_replica
            for child in children.values():
                try:
                    drain_replica(server.registry, server.metrics,
                                  child.netloc,
                                  timeout_s=cfg.migrate_timeout_s)
                except Exception:                  # noqa: BLE001
                    _logger.exception("drain of %s on exit failed",
                                      child.netloc)
        for child in children.values():
            child.stop()
        server.server_close()
        _logger.info("bye")


if __name__ == "__main__":
    main(sys.argv[1:])
