"""Observability of a run: the JSONL event/metrics log (``events``).

The counterpart of ``deepfake_detection_tpu/obs``; ``events`` is ported
(the backfill runner's telemetry and its verdict writer's torn-tail
repair).  The trainer's telemetry tracker, profiler capture and metrics
endpoint are still to port (ROADMAP Queue 1, item 8).
"""

from .events import (SCHEMA_VERSION, EventLog, iter_records, read_records,
                     repair_torn_tail)

__all__ = ["SCHEMA_VERSION", "EventLog", "iter_records", "read_records",
           "repair_torn_tail"]
