"""Per-shard verdict JSONL + the exact-books auditor.

Each leased shard appends one ``dfd.backfill.verdict.v1`` record per
clip to ``verdicts/<shard>.jsonl`` with the obs/events write discipline
(one ``json.dumps`` line + flush per record, so a kill can tear at most
the final line) and is committed by the lease layer's done marker only
after the file is fsynced.  Records are **deterministic** — no
timestamps, no worker names — because the chaos acceptance criterion
compares a killed+resumed run's concatenated verdicts against an
unkilled run's, order-normalized: any nondeterministic field would make
that identity unfalsifiable.

Resume contract (how "no clip scored twice" survives a mid-shard
death): a worker that re-leases a partially written shard opens the
writer, which first repairs the torn tail
(:func:`..obs.events.repair_torn_tail`, the one truncation routine the
package shares) and reads the clip keys
already recorded; the runner then scores only the remainder.  The
re-leased *shard* is the unit of recovery; the surviving records within
it are kept, not re-scored.

:func:`collect_books` is the auditor both the runner's exit path and
the chaos harness call: ``manifest clips == scored + failed +
skipped_dup``, with duplicates and missing clips named, never
summarized away.  ``skipped_dup`` records (the ``--dedup`` pass:
clips whose canonical pixel content already occurs earlier in the
manifest) carry ``dup_of`` naming the canonical clip — a skip is a
booked decision, never a silently absent row.

A copy of ``deepfake_detection_tpu/backfill/writer.py``: the same
records, so either package's auditor reads the other's run dir.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from ..obs.events import repair_torn_tail

__all__ = ["VERDICT_SCHEMA", "ShardVerdictWriter", "clip_key",
           "collect_books", "read_verdicts", "verdict_path"]

VERDICT_SCHEMA = "dfd.backfill.verdict.v1"
_VERDICTS = "verdicts"

#: a clip's identity in the books: (kind, root_index, clip_name)
Key = Tuple[str, int, str]


def clip_key(rec: Dict[str, Any]) -> Key:
    return (rec["kind"], int(rec["root"]), rec["clip"])


def verdict_path(run_dir: str, shard_id: str) -> str:
    return os.path.join(run_dir, _VERDICTS, f"{shard_id}.jsonl")


class ShardVerdictWriter:
    """Append-only verdict stream for one leased shard.

    Opening repairs a torn tail left by a killed predecessor and indexes
    the surviving records, so :attr:`scored_keys` is exactly the set of
    clips the resuming runner must skip.
    """

    def __init__(self, run_dir: str, shard_id: str):
        self.shard_id = shard_id
        self.path = verdict_path(run_dir, shard_id)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.torn_bytes_dropped = repair_torn_tail(self.path)
        self.scored_keys: Set[Key] = set()
        self.records = 0
        self.failed = 0
        self.skipped = 0          # skipped_dup records (--dedup pass)
        # ONE pass over the surviving bytes indexes the records AND
        # seeds the incremental content hash, so finalize() never
        # re-reads the stream — shard opens are a measurable cost under
        # slow syscall layers
        self._sha = hashlib.sha256()
        try:
            with open(self.path, "rb") as f:
                for raw in f:
                    self._sha.update(raw)
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("schema") != VERDICT_SCHEMA:
                        continue
                    self.scored_keys.add(clip_key(rec))
                    self.records += 1
                    if rec.get("skipped_dup"):
                        self.skipped += 1
                    elif not rec.get("ok"):
                        self.failed += 1
        except OSError:
            pass
        self._f = open(self.path, "a", encoding="utf-8")

    def _record(self, kind: str, root: int, clip: str, label: int,
                score: Optional[float], err: str) -> Dict[str, Any]:
        ok = score is not None
        rec = {"schema": VERDICT_SCHEMA, "shard": self.shard_id,
               "kind": kind, "root": int(root), "clip": clip,
               "label": int(label), "ok": ok,
               "score": float(score) if ok else None}
        if err:
            rec["err"] = err
        return rec

    def _book(self, rec: Dict[str, Any]) -> None:
        self.scored_keys.add(clip_key(rec))
        self.records += 1
        if rec.get("skipped_dup"):
            self.skipped += 1
        elif not rec["ok"]:
            self.failed += 1

    def append(self, kind: str, root: int, clip: str, label: int,
               score: Optional[float], err: str = "") -> None:
        """One clip's verdict: ``score`` is P(fake) (None for a failed
        clip, which records ``ok=false`` + the error instead)."""
        rec = self._record(kind, root, clip, label, score, err)
        line = json.dumps(rec, separators=(",", ":"),
                          allow_nan=False) + "\n"
        self._f.write(line)
        self._f.flush()
        self._sha.update(line.encode())
        self._book(rec)

    def append_many(self, rows) -> None:
        """One device batch's verdicts in one write + one flush (the hot
        loop's path — per-record flush syscalls are measurable at
        saturation).  ``rows``: ``(kind, root, clip, label, score, err)``
        tuples; each row is still serialized to its own schema-stamped
        single line, so kill-tearing semantics are unchanged."""
        recs = [self._record(*row) for row in rows]
        if not recs:
            return
        text = "".join(
            json.dumps(r, separators=(",", ":"), allow_nan=False) + "\n"
            for r in recs)
        self._f.write(text)
        self._f.flush()
        self._sha.update(text.encode())
        for rec in recs:
            self._book(rec)

    def append_dups(self, rows) -> None:
        """Book a batch of duplicate clips without scoring them.
        ``rows``: ``(kind, root, clip, label, dup_of)`` tuples, where
        ``dup_of`` names the canonical clip (``kind/root/clip``) whose
        identical pixel content occurs earlier in the manifest.  The
        record carries ``skipped_dup: true`` + ``dup_of`` so the books
        auditor can bucket it apart from scored AND from failed —
        a dedup skip is a decision, not damage."""
        recs = []
        for kind, root, clip, label, dup_of in rows:
            rec = self._record(kind, root, clip, label, None, "")
            rec["skipped_dup"] = True
            rec["dup_of"] = dup_of
            recs.append(rec)
        if not recs:
            return
        text = "".join(
            json.dumps(r, separators=(",", ":"), allow_nan=False) + "\n"
            for r in recs)
        self._f.write(text)
        self._f.flush()
        self._sha.update(text.encode())
        for rec in recs:
            self._book(rec)

    def finalize(self) -> Dict[str, Any]:
        """fsync the stream and return the shard's book entry (what the
        done marker records): counts + content hash of the JSONL."""
        self._f.flush()
        os.fsync(self._f.fileno())
        return {"clips": self.records,
                "scored": self.records - self.failed - self.skipped,
                "failed": self.failed, "skipped_dup": self.skipped,
                "sha256": self._sha.hexdigest()}

    def tear(self) -> None:
        """Chaos seam (``backfill_torn_shard``): leave exactly the damage
        a mid-``write`` kill leaves — half a record, no terminating
        newline — flushed to disk so the relaunch's
        :func:`repair_torn_tail` has something real to repair."""
        self._f.write('{"schema":"' + VERDICT_SCHEMA + '","shard":"'
                      + self.shard_id + '","clip":"torn-mid-wri')
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "ShardVerdictWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_verdicts(path: str) -> List[Dict[str, Any]]:
    """Parsed verdict records (empty for a missing file).  A torn tail is
    tolerated read-side (skipped) but writers repair it instead."""
    out: List[Dict[str, Any]] = []
    try:
        f = open(path, encoding="utf-8")
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue                        # torn tail (read-side)
            if rec.get("schema") == VERDICT_SCHEMA:
                out.append(rec)
    return out


def collect_books(run_dir: str, manifest: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """The exact-books audit over a run dir's verdict files.

    Walks every manifest shard's JSONL and checks the one identity the
    whole subsystem exists to uphold::

        manifest clips == scored + failed + skipped_dup,
        each clip exactly once

    (``skipped_dup`` is zero unless the run used ``--dedup``: a clip
    whose canonical pixel content duplicates an earlier manifest clip
    books a skip record instead of a score — still exactly one row.)

    Returns counts plus the *named* discrepancies (missing /
    duplicated / alien clips) and ``balanced`` — True iff every shard
    is done and the identity holds exactly.
    """
    from .lease import _DONE             # cycle-free: lease imports no one
    expected: Set[Key] = set()
    for s in manifest["shards"]:
        for kind, ri, name, _num in s["clips"]:
            expected.add((kind, int(ri), name))
    seen: Dict[Key, int] = {}
    scored = failed = skipped = 0
    shards_done = 0
    for s in manifest["shards"]:
        if os.path.isfile(os.path.join(run_dir, _DONE,
                                       f"{s['id']}.json")):
            shards_done += 1
        for rec in read_verdicts(verdict_path(run_dir, s["id"])):
            key = clip_key(rec)
            seen[key] = seen.get(key, 0) + 1
            if rec.get("skipped_dup"):
                skipped += 1
            elif rec.get("ok"):
                scored += 1
            else:
                failed += 1
    missing = sorted("/".join(map(str, k)) for k in expected - set(seen))
    alien = sorted("/".join(map(str, k)) for k in set(seen) - expected)
    dup = sorted("/".join(map(str, k)) for k, n in seen.items() if n > 1)
    complete = shards_done == len(manifest["shards"])
    balanced = (complete and not missing and not alien and not dup
                and scored + failed + skipped ==
                int(manifest["num_clips"]))
    return {"manifest_clips": int(manifest["num_clips"]),
            "scored": scored, "failed": failed,
            "skipped_dup": skipped,
            "shards_done": shards_done,
            "shards_total": len(manifest["shards"]),
            "missing": missing, "duplicated": dup, "alien": alien,
            "complete": complete, "balanced": balanced}
