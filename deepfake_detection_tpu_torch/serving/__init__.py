"""Dynamic-batching inference serving, on the card.

The counterpart of ``deepfake_detection_tpu/serving``: ``batcher``
coalesces arrival-order requests into batch buckets, ``engine`` holds the
models on the device with one captured CUDA graph per (model, bucket,
channel width), double-buffered staging and hot weight reload, ``http`` is
the stdlib front end, ``metrics`` the Prometheus-text observability,
``config`` the runner's flags.  Entry point:
``python -m deepfake_detection_tpu_torch.runners.serve``.

Lazy exports: importing the package loads no submodule.
"""

from __future__ import annotations

_LAZY = {
    "MicroBatcher": "batcher", "Request": "batcher", "QueueFull": "batcher",
    "DeadlineExceeded": "batcher", "pick_bucket": "batcher",
    "InferenceEngine": "engine", "DEFAULT_BUCKETS": "engine",
    "ServingMetrics": "metrics",
    "ServingServer": "http", "make_server": "http",
    "serve_forever_in_thread": "http",
    "CascadeRouter": "cascade", "CascadeResult": "cascade",
    "ServeConfig": "config",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
