"""Structured JSONL event/metrics log of a run.

A copy of ``deepfake_detection_tpu/obs/events.py`` (standard library
only), with the same record schema, so ``tools/obs_report.py`` renders
the port's run directories.  One file per writer, append-only, one JSON
object per line.  Two record types share a schema version:

* ``{"v": 1, "t": <unix s>, "type": "metrics", ...}`` — one per drain
  window (the backfill runner writes one per shard), and
* ``{"v": 1, "t": <unix s>, "type": "event", "event": <name>, ...}`` —
  one per lifecycle transition (run_start, lease_steal, run_end, ...).

Resume coherence: a SIGTERM can land mid-``write`` and leave a torn last
line; reopening for append first truncates the file back to its last
complete record (``\\n``-terminated), so a killed and relaunched run
produces ONE parseable stream, with no torn and no duplicate records.
:func:`repair_torn_tail` is the same truncation, shared with the backfill
verdict writer.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

_logger = logging.getLogger(__name__)

__all__ = ["SCHEMA_VERSION", "EventLog", "read_records",
           "repair_torn_tail"]

#: bump when a record's field meaning changes; readers must check it
SCHEMA_VERSION = 1


def _repair_torn_tail(path: str) -> int:
    """Truncate a trailing partial line; returns bytes dropped (0 if clean).

    A record writer killed mid-``os.write`` leaves bytes with no final
    newline.  Scanning back to the last ``\\n`` (not json-validating every
    line) is enough: records are written atomically-per-line below, so the
    only corruption a kill can produce is exactly one torn tail.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb+") as f:
        f.seek(-1, io.SEEK_END)
        if f.read(1) == b"\n":
            return 0
        # walk back in chunks to the last newline
        pos = size
        chunk = 4096
        keep = 0
        while pos > 0:
            step = min(chunk, pos)
            f.seek(pos - step)
            buf = f.read(step)
            nl = buf.rfind(b"\n")
            if nl >= 0:
                keep = pos - step + nl + 1
                break
            pos -= step
        f.truncate(keep)
        dropped = size - keep
    _logger.warning("telemetry log %s had a torn tail (%d bytes dropped); "
                    "truncated to the last complete record", path, dropped)
    return dropped


#: public name for the torn-tail repair (the streaming session-durability
#: layer reopens per-stream verdict JSONL files with the same discipline)
repair_torn_tail = _repair_torn_tail


class EventLog:
    """Append-only JSONL writer with torn-tail repair on open.

    Thread-safe (the metrics HTTP thread and the train loop may both
    record); each record is serialized to one line and written with a
    single ``write`` + ``flush`` so a kill can tear at most the final
    line — which the next open repairs.
    """

    def __init__(self, path: str):
        self.path = path
        self.torn_bytes_dropped = _repair_torn_tail(path)
        self._lock = threading.Lock()
        self._f: Optional[Any] = open(path, "a", encoding="utf-8")
        self.records_written = 0

    # ------------------------------------------------------------------
    def write(self, record: Dict[str, Any]) -> None:
        rec = {"v": SCHEMA_VERSION, "t": round(time.time(), 3)}
        rec.update(record)
        line = json.dumps(_sanitize(rec), separators=(",", ":"),
                          allow_nan=False, default=_json_default) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)
            self._f.flush()
            self.records_written += 1

    def event(self, name: str, **fields: Any) -> None:
        self.write({"type": "event", "event": name, **fields})

    def metrics(self, **fields: Any) -> None:
        self.write({"type": "metrics", **fields})

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _json_default(o):
    """numpy scalars and other float-likes appear in metric dicts; a
    telemetry record must never crash the train loop over serialization."""
    try:
        f = float(o)
    except (TypeError, ValueError):
        return repr(o)
    return None if f != f or f in (float("inf"), float("-inf")) else f


def _sanitize(o):
    """Non-finite floats → null: the stream must stay STRICT JSON (jq,
    non-Python consumers) even when an eval loss goes NaN."""
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    if isinstance(o, float) and (o != o or o in (float("inf"),
                                                 float("-inf"))):
        return None
    return o


def iter_records(path: str, strict_version: bool = False
                 ) -> Iterator[Dict[str, Any]]:
    """Yield parsed records, skipping (with a warning) torn/corrupt lines."""
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                _logger.warning("%s:%d unparseable record skipped", path, ln)
                continue
            if strict_version and rec.get("v") != SCHEMA_VERSION:
                _logger.warning("%s:%d schema v%r != %d skipped",
                                path, ln, rec.get("v"), SCHEMA_VERSION)
                continue
            yield rec


def read_records(path: str) -> List[Dict[str, Any]]:
    return list(iter_records(path))
