"""Shard leases: atomic filesystem claims with mtime-based expiry.

N worker processes (possibly on N hosts over a shared filesystem)
coordinate through two directories in the backfill run dir, with no
coordinator process and no network protocol:

* ``leases/<shard>.lease`` — the claim.  Acquisition is an atomic
  test-and-set built from the pack_dataset write→fsync→atomic-link
  idiom: the owner record is written to a private tmp file, fsynced,
  and ``os.link``ed to the lease path — link fails with ``EEXIST`` iff
  another worker already holds the shard, and never leaves a partial
  lease behind.  A live owner **heartbeats** the lease (``os.utime``)
  between batches; a lease whose mtime is older than ``ttl_s`` belonged
  to a dead host and may be broken — the break itself is an atomic
  ``os.rename`` of the stale lease to a per-contender name, so exactly
  ONE contender wins the right to re-lease even when several notice the
  expiry simultaneously.
* ``done/<shard>.json`` — the commit marker, written atomically
  (write→fsync→rename) AFTER the shard's verdict JSONL is durable.  A
  done shard is never re-leased (acquire refuses), so completion is
  idempotent: relaunches skip finished work at shard granularity.

The TTL contract (documented, not enforced): ``ttl_s`` must exceed the
worst heartbeat gap — one device batch plus slack — or a merely *slow*
owner can be mistaken for a dead one and its shard double-scored.  The
runner heartbeats every batch, checks :meth:`LeaseDir.still_owner`
at the same cadence, and abandons a shard it no longer owns instead of
committing it.

A copy of ``deepfake_detection_tpu/backfill/lease.py`` (standard library
only): the two packages' workers can share one run dir.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["LeaseDir"]

_LEASES = "leases"
_DONE = "done"


class LeaseDir:
    """One worker's handle on the shared lease/done state of a run dir."""

    def __init__(self, run_dir: str, owner: str, ttl_s: float = 600.0):
        if ttl_s <= 0:
            raise ValueError(f"lease ttl_s must be > 0, got {ttl_s}")
        self.run_dir = os.fspath(run_dir)
        self.owner = str(owner)
        #: lease IDENTITY — the owner name plus a per-process random
        #: token, so two workers accidentally launched with the same
        #: --worker-name can never pass each other's ``still_owner``
        #: check after a steal (owner strings are display/telemetry)
        self.token = f"{self.owner}:{os.getpid()}:{os.urandom(4).hex()}"
        self.ttl_s = float(ttl_s)
        self.lease_dir = os.path.join(self.run_dir, _LEASES)
        self.done_dir = os.path.join(self.run_dir, _DONE)
        os.makedirs(self.lease_dir, exist_ok=True)
        os.makedirs(self.done_dir, exist_ok=True)
        self._steal_seq = 0
        #: owner record of the last stale lease this worker broke (None
        #: until a steal happens) — surfaced into telemetry by the runner
        self.last_steal: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    def _lease_path(self, shard_id: str) -> str:
        return os.path.join(self.lease_dir, f"{shard_id}.lease")

    def _done_path(self, shard_id: str) -> str:
        return os.path.join(self.done_dir, f"{shard_id}.json")

    _tmp_seq = itertools.count()      # class-level: unique across ALL
    # instances in a process (pid alone collides when threads of one
    # process race a claim — tests drive leases that way)

    def _try_claim(self, shard_id: str) -> bool:
        """The atomic test-and-set: tmp write → fsync → link."""
        path = self._lease_path(shard_id)
        tmp = (f"{path}.tmp.{os.getpid()}.{threading.get_ident()}."
               f"{next(self._tmp_seq)}")
        with open(tmp, "w") as f:
            json.dump({"owner": self.owner, "token": self.token,
                       "pid": os.getpid(), "shard": shard_id}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)        # EEXIST iff someone else holds it
            return True
        except FileExistsError:
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _claim_checked(self, shard_id: str) -> bool:
        """Claim + re-check done (a commit can land between the caller's
        done check and the link) — never hold a lease on a done shard."""
        if not self._try_claim(shard_id):
            return False
        if self.is_done(shard_id):
            self.release(shard_id)
            return False
        return True

    def acquire(self, shard_id: str) -> bool:
        """Claim ``shard_id``; False = done already, someone else holds a
        live lease, or we lost the break-stale race — the caller moves on
        to the next shard (the loser's contract)."""
        if self.is_done(shard_id):
            return False
        if self._claim_checked(shard_id):
            return True
        # claim lost: live owner, or a dead host's stale leftover?
        path = self._lease_path(shard_id)
        try:
            age = time.time() - os.stat(path).st_mtime
        except OSError:
            # the holder released/committed between our link and stat;
            # one clean retry, then defer to the next sweep
            return self._claim_checked(shard_id)
        if age <= self.ttl_s:
            return False              # live owner — respect the lease
        # stale: break it atomically.  rename succeeds for exactly one
        # contender; everyone else gets ENOENT and loses cleanly.
        self._steal_seq += 1
        grave = f"{path}.stale.{os.getpid()}.{self._steal_seq}"
        try:
            os.rename(path, grave)
        except OSError:
            return False              # another contender broke it first
        try:
            with open(grave) as f:
                prev = json.load(f)
        except (OSError, json.JSONDecodeError):
            prev = {}
        try:
            os.remove(grave)
        except OSError:
            pass
        claimed = self._claim_checked(shard_id)
        if claimed:
            # visible in logs/telemetry: a re-lease means a dead (or
            # TTL-starved) worker — silence here would hide flapping
            self.last_steal = prev
        return claimed

    def heartbeat(self, shard_id: str) -> None:
        """Refresh the lease mtime (the liveness signal expiry reads)."""
        try:
            os.utime(self._lease_path(shard_id))
        except OSError:
            pass                      # lost the lease; still_owner says so

    def still_owner(self, shard_id: str) -> bool:
        """True while OUR lease record is the one on disk (compared by
        the per-process token, not the display name).  A worker that
        lost its lease (TTL expiry while stalled) must NOT commit the
        shard — the stealer owns its books now."""
        try:
            with open(self._lease_path(shard_id)) as f:
                return json.load(f).get("token") == self.token
        except (OSError, json.JSONDecodeError):
            return False

    def release(self, shard_id: str) -> None:
        """Drop our lease — atomically, so a steal landing between an
        ownership check and a bare unlink can never delete the STEALER's
        live lease.  The file is renamed to a private grave first; if it
        turns out not to be ours it is restored (``os.link`` back — and
        if a third worker claimed the briefly-empty slot, its claim
        stands and the displaced owner notices via ``still_owner``)."""
        if not self.still_owner(shard_id):
            # clearly not ours (already released, or stolen): touching
            # the file at all would make the rename below briefly hide
            # the rightful owner's lease from its own liveness checks
            return
        path = self._lease_path(shard_id)
        self._steal_seq += 1
        grave = f"{path}.release.{os.getpid()}.{self._steal_seq}"
        try:
            os.rename(path, grave)
        except OSError:
            return                    # no lease (already released/stolen)
        try:
            with open(grave) as f:
                mine = json.load(f).get("token") == self.token
        except (OSError, json.JSONDecodeError):
            mine = True               # unreadable = not worth restoring
        if not mine:
            try:
                os.link(grave, path)  # put the rightful owner's back
            except OSError:
                pass                  # someone claimed meanwhile — theirs
        try:
            os.remove(grave)
        except OSError:
            pass

    # ------------------------------------------------------------------
    def mark_done(self, shard_id: str, record: Dict[str, Any]) -> bool:
        """Commit the shard: done marker lands atomically, then the lease
        is released.  Refuses (False) when the lease was lost — the
        shard's verdicts will be re-derived by the current owner.
        Idempotent: marking an already-done shard is a no-op (True)."""
        if self.is_done(shard_id):
            self.release(shard_id)
            return True
        if not self.still_owner(shard_id):
            return False
        path = self._done_path(shard_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dict(record, shard=shard_id, owner=self.owner), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.release(shard_id)
        return True

    def is_done(self, shard_id: str) -> bool:
        return os.path.isfile(self._done_path(shard_id))

    def done_record(self, shard_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._done_path(shard_id)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def pending_shards(self, manifest: Dict[str, Any]) -> List[str]:
        """Manifest shards with no done marker, in manifest order."""
        return [s["id"] for s in manifest["shards"]
                if not self.is_done(s["id"])]
