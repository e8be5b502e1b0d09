"""Observability of a run: the JSONL event/metrics log, the trainer's
telemetry, its metrics endpoint and on-demand profiler capture.

The counterpart of ``deepfake_detection_tpu/obs``: a per-step time
breakdown riding the trainer's drain with no extra device sync and a live
MFU gauge (``telemetry``), the schema-versioned JSONL log in the run dir
(``events``, also the backfill runner's), a stdlib ``--metrics-port``
Prometheus endpoint (``server``) and bounded ``torch.profiler`` windows on
SIGUSR2 or a ``PROFILE`` file (``profiler``).

``events`` is imported eagerly and the rest lazily (PEP 562), so a
reporting process (``tools/obs_report.py``) and the router side read
telemetry logs without importing torch.
"""

from .events import (SCHEMA_VERSION, EventLog, iter_records, read_records,
                     repair_torn_tail)

# lazily resolved attributes: name -> submodule
_LAZY = {
    "TrainTelemetry": "telemetry", "forward_flops_per_sample": "telemetry",
    "flops_buckets": "telemetry", "loader_collector": "telemetry",
    "peak_flops": "telemetry", "resilience_collector": "telemetry",
    "MetricsServer": "server", "start_metrics_server": "server",
    "ProfilerCapture": "profiler", "TRIGGER_FILENAME": "profiler",
}

__all__ = ["SCHEMA_VERSION", "EventLog", "iter_records", "read_records",
           "repair_torn_tail", *sorted(_LAZY)]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value        # cache: __getattr__ runs once a name
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
