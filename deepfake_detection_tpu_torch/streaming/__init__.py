"""Streaming-video scoring subsystem: live streams in, verdicts out.

Counterpart of ``deepfake_detection_tpu/streaming``, one process in front
of the port's serving engine:

``POST /streams/<id>/frames`` chunks → decode (raw wire, JPEG, or Pillow) →
face localize + greedy-IoU track (``tracker``) → per-track temporal
windows of ``img_num`` distinct frames (``windows``) → serving engine's
captured buckets (one CUDA graph per model, bucket and channel width) →
EMA + hysteresis verdict machines (``verdict``) → schema-versioned
events + ``/metrics``.

Entry point: ``python -m deepfake_detection_tpu_torch.runners.stream``.

PEP-562 lazy exports: importing the package does not pull torch or
Pillow, so the ``tracker``/``verdict``/``windows`` unit tests stay cheap.
"""

from __future__ import annotations

_LAZY = {
    "FaceLocalizer": "tracker",
    "FullFrameLocalizer": "tracker",
    "CallableLocalizer": "tracker",
    "GreedyIouTracker": "tracker",
    "make_localizer": "tracker",
    "register_localizer": "tracker",
    "iou": "tracker",
    "crop_box": "tracker",
    "VerdictMachine": "verdict",
    "VerdictThresholds": "verdict",
    "TrackWindower": "windows",
    "WindowDispatcher": "windows",
    "WindowJob": "windows",
    "build_payload": "windows",
    "CanvasRing": "ring",
    "FrameRef": "ring",
    "FrameStack": "ring",
    "RingLease": "ring",
    "frame_digest": "ring",
    "window_key": "ring",
    "StreamingMetrics": "metrics",
    "StreamManager": "ingest",
    "StreamSession": "ingest",
    "StreamServer": "ingest",
    "make_stream_server": "ingest",
    "FfmpegDemuxer": "ingest",
    "parse_verdict_vector": "ingest",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
