"""Fleet scale-out: a shared-nothing replica router tier.

One serve/stream process per unit of capacity, N of them behind a
stdlib-HTTP router (``runners/router.py``): consistent-hash stream
affinity, health derived from the signals the replicas already export
(``/readyz`` + ``/metrics``), shed-aware retry routing honoring each
replica's Retry-After, and live stream migration on drain via the
streaming runner's session snapshot/restore machinery.

Deliberately **torch-free top to bottom** (pinned by
``tests/test_torch_fleet.py``): the router tier must never pay — or wait
on — an accelerator import; replicas are separate processes that do.

The counterpart of ``deepfake_detection_tpu/fleet``: the same modules,
names, books, metric names and JSON documents; spawned children run the
port's runners.

PEP-562 lazy exports (the ``obs/`` idiom) keep ``import
deepfake_detection_tpu_torch.fleet`` cheap for config/tests.
"""

from __future__ import annotations

_LAZY = {
    "HashRing": "registry",
    "Replica": "registry",
    "Registry": "registry",
    "normalize_netloc": "registry",
    "RouterMetrics": "metrics",
    "relabel_exposition": "metrics",
    "HealthScraper": "controller",
    "ReplicaProcess": "controller",
    "spawn_replicas": "controller",
    "free_port": "controller",
    "http_request": "controller",
    "parse_exposition": "controller",
    "retire_replica": "controller",
    "RouterServer": "router",
    "make_router_server": "router",
    "drain_replica": "migrate",
    "undrain_replica": "migrate",
    "migrate_stream": "migrate",
    "list_streams": "migrate",
    "Autoscaler": "autoscaler",
    "BackfillTenant": "autoscaler",
    "FleetSample": "autoscaler",
    "FleetSampler": "autoscaler",
    "PolicyKnobs": "autoscaler",
    "ScalePolicy": "autoscaler",
    "replay_trace": "autoscaler",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
