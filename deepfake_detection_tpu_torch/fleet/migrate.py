"""Live stream migration: drain a replica by moving its sessions.

Built on the streaming runner's session-durability machinery, extended
from *restart* to *migration*: the streaming server's ``POST
/streams/<id>/migrate`` exports a session as the exact
``dfd.streaming.session_state.v1`` snapshot a ``--state-dir`` shutdown
would have written (quiesced, with in-flight windows booked dropped so
per-stream books balance), and ``POST /streams/restore`` rebuilds the
session — verdict machines, tracker, window buffers, counters, event
tail — on another replica.
Restart resume continues the session; migration rides the SAME
snapshot/restore code path (``tests/test_torch_fleet.py`` holds a
migrated stream's window scores to an undrained run).  The counterpart
of ``deepfake_detection_tpu/fleet/migrate.py``.

Failure contract (the README failure-mode table's migration-abort row):
a session is NEVER silently lost mid-move.  If the target restore
fails, the state restores back onto the source (still alive — it was
draining, not dead); if even that fails, the snapshot is dumped to a
``.state.json.bad`` file next to the router log and counted in
``dfd_router_migration_aborts_total``.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional

from .controller import http_request
from .metrics import RouterMetrics
from .registry import Registry

_logger = logging.getLogger(__name__)

__all__ = ["drain_replica", "undrain_replica", "migrate_stream",
           "list_streams"]


def list_streams(netloc: str, timeout_s: float = 5.0) -> List[str]:
    status, _, body = http_request(netloc, "GET", "/streams",
                                   timeout=timeout_s)
    if status != 200:
        raise OSError(f"GET /streams on {netloc} returned {status}")
    return list(json.loads(body).get("streams", []))


def _restore(netloc: str, state: dict, timeout_s: float) -> None:
    status, _, body = http_request(
        netloc, "POST", "/streams/restore",
        json.dumps(state, sort_keys=True).encode(),
        {"Content-Type": "application/json"}, timeout=timeout_s)
    if status not in (200, 201):
        raise OSError(f"restore on {netloc} returned {status}: "
                      f"{body[:200]!r}")


def migrate_stream(registry: Registry, metrics: RouterMetrics,
                   stream_id: str, source_id: str, target_id: str,
                   timeout_s: float = 30.0) -> bool:
    """Move one live session ``source → target``; True on success.

    Export quiesces + detaches the session on the source (the replica
    side owes nothing to this stream afterwards), restore rebuilds it on
    the target, and the registry override re-pins the stream's routing.
    """
    status, _, body = http_request(
        registry.get(source_id).netloc, "POST",
        f"/streams/{stream_id}/migrate", b"", timeout=timeout_s)
    if status != 200:
        raise OSError(f"export of stream {stream_id!r} on {source_id} "
                      f"returned {status}: {body[:200]!r}")
    state = json.loads(body)
    try:
        _restore(registry.get(target_id).netloc, state, timeout_s)
    except (OSError, ValueError) as e:
        _logger.error("stream %s: restore on target %s failed (%s); "
                      "restoring back on source %s", stream_id,
                      target_id, e, source_id)
        metrics.migration_aborts_total.inc()
        try:
            _restore(registry.get(source_id).netloc, state, timeout_s)
            # routing truth: the session is back on the SOURCE.  If the
            # source is the ring home no override is needed; if the
            # source was itself a migration target (a second drain), the
            # override must keep pointing AT it — clearing would strand
            # the session behind the ring home
            if registry.ring.assign(stream_id) == source_id:
                registry.clear_override(stream_id)
            else:
                registry.set_override(stream_id, source_id)
        except (OSError, ValueError):
            # last resort: the snapshot goes to disk, loudly — a session
            # must never be silently lost mid-move
            path = os.path.join(
                tempfile.gettempdir(),
                f"dfd-migrate-{stream_id}.state.json.bad")
            with open(path, "w") as f:
                f.write(json.dumps(state, sort_keys=True))
            _logger.error("stream %s: source restore ALSO failed; "
                          "snapshot dumped to %s", stream_id, path)
        return False
    registry.set_override(stream_id, target_id)
    metrics.streams_migrated_total.inc()
    _logger.info("stream %s migrated %s -> %s (%d windows scored)",
                 stream_id, source_id, target_id,
                 int(state.get("counters", {}).get("windows_scored", 0)))
    return True


def drain_replica(registry: Registry, metrics: RouterMetrics,
                  replica_id: str, timeout_s: float = 30.0
                  ) -> Dict[str, object]:
    """Drain one replica: stop routing new traffic to it, then migrate
    each of its live streams to its ring successor.

    The replica keeps serving its in-flight work (it is draining, not
    dead); streams move one at a time so a mid-drain failure leaves
    every session either still on the source or fully restored on its
    target — never in between.  Returns a report dict (also the HTTP
    response body of ``POST /replicas/<id>/drain``).
    """
    src = registry.get(replica_id)
    if src is None:
        raise KeyError(f"unknown replica {replica_id!r}")
    src.draining = True
    metrics.drains_total.inc()
    metrics.set_fleet_gauges(registry.counts())
    t0 = time.monotonic()
    migrated: List[str] = []
    failed: List[str] = []
    skipped: List[str] = []
    try:
        streams = list_streams(src.netloc, timeout_s)
    except OSError as e:
        # a dead replica has nothing to export; its streams come back via
        # --state-dir restore when it relaunches (the replica-kill path)
        return {"replica": replica_id, "draining": True,
                "streams": 0, "migrated": [], "failed": [],
                "skipped": [], "error": f"cannot list streams: {e}"}
    for sid in streams:
        target_id = registry.ring.assign(
            sid, eligible={r.id for r in registry.eligible({replica_id})})
        if target_id is None:
            _logger.warning("stream %s: no eligible migration target; "
                            "leaving it on draining %s", sid, replica_id)
            skipped.append(sid)
            continue
        try:
            ok = migrate_stream(registry, metrics, sid, replica_id,
                                target_id, timeout_s)
        except (OSError, ValueError) as e:
            _logger.error("stream %s: migration failed before export "
                          "completed (%s)", sid, e)
            metrics.migration_aborts_total.inc()
            ok = False
        (migrated if ok else failed).append(sid)
    return {"replica": replica_id, "draining": True,
            "streams": len(streams), "migrated": migrated,
            "failed": failed, "skipped": skipped,
            "elapsed_s": round(time.monotonic() - t0, 3)}


def undrain_replica(registry: Registry, metrics: RouterMetrics,
                    replica_id: str) -> Dict[str, object]:
    """Return a drained replica to rotation (overrides written by its
    drain stay — migrated sessions live where they were restored)."""
    r = registry.get(replica_id)
    if r is None:
        raise KeyError(f"unknown replica {replica_id!r}")
    r.draining = False
    metrics.set_fleet_gauges(registry.counts())
    return {"replica": replica_id, "draining": False}
