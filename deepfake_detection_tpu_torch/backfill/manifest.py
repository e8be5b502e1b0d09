"""The backfill work manifest: the corpus chopped into leaseable shards.

One JSON file (schema ``dfd.backfill.manifest.v1``) fixes, up front and
immutably, WHAT a backfill run scores: every clip of the corpus in
deterministic order (root-major, fakes before reals — the pack
convention), grouped into fixed-size shards that are the unit of
leasing, resume and accounting.  Exact books are only meaningful
against a frozen denominator, so the manifest carries a **source
fingerprint** the runner re-derives from its live sources at startup:
list files that changed since the manifest was built, or a pack with a
different fingerprint, are a loud :class:`BackfillManifestStale` (the
``PackedCacheStale`` contract of data/packed.py), never a run that
silently scores a skewed corpus.

Two builders share the shard arithmetic:

* :func:`build_manifest_from_lists` — from the v3
  ``real_list.txt``/``fake_list.txt`` roots (the raw-tree path);
* :func:`build_manifest_from_pack` — from a pack's own index
  (``data/packed.write_pack``), inheriting the pack's fingerprint so the
  manifest is stale exactly when the pack is.

A copy of ``deepfake_detection_tpu/backfill/manifest.py`` over the port's
``data/packed``: for the same pack or lists it writes the same JSON as
the JAX module, so either package's runner takes it.  ``python -m
deepfake_detection_tpu_torch.backfill.manifest ROOT --manifest m.json
[--packed PACK] [--shard-clips N]`` writes one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..data.packed import load_index, read_source_lists

__all__ = ["MANIFEST_SCHEMA", "BackfillManifestStale",
           "build_manifest_from_lists", "build_manifest_from_pack",
           "load_manifest", "manifest_entries", "save_manifest",
           "verify_manifest_source"]

MANIFEST_SCHEMA = "dfd.backfill.manifest.v1"

#: one manifest entry: (kind, root_index, clip_name, num_frames)
Entry = Tuple[str, int, str, int]

_REQUIRED_KEYS = ("schema", "shard_clips", "source", "fingerprint",
                  "num_clips", "shards")


class BackfillManifestStale(RuntimeError):
    """The manifest disagrees with the live sources (list files changed,
    pack rebuilt, shard table damaged).  Rebuild the manifest rather than
    backfilling a corpus that is not the one the books will claim."""


def _lists_fingerprint(lists: List[Dict[str, list]]) -> str:
    payload = json.dumps(lists, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def _entries_from_lists(lists: List[Dict[str, list]]) -> List[Entry]:
    """Deterministic corpus order: root-major, fakes before reals — the
    exact order ``data/packed.py::write_pack`` packs, so a manifest over
    a pack and one over the pack's source lists enumerate identically."""
    entries: List[Entry] = []
    for ri in range(len(lists)):
        for kind in ("fake", "real"):
            entries += [(kind, ri, name, int(num))
                        for name, num in lists[ri][kind]]
    return entries


def _shard_table(entries: List[Entry], shard_clips: int) -> List[Dict]:
    if shard_clips < 1:
        raise ValueError(f"shard_clips must be >= 1, got {shard_clips}")
    shards = []
    for si in range(0, len(entries), shard_clips):
        chunk = entries[si:si + shard_clips]
        shards.append({
            "id": f"shard-{si // shard_clips:05d}",
            "clips": [[k, ri, name, num] for k, ri, name, num in chunk],
        })
    return shards


def _finish(source: Dict[str, Any], source_fp: str, entries: List[Entry],
            shard_clips: int) -> Dict[str, Any]:
    if not entries:
        raise ValueError(f"no clips to manifest from source {source}")
    shards = _shard_table(entries, int(shard_clips))
    # the manifest's own fingerprint covers source identity AND the shard
    # layout, so two manifests over one corpus with different --shard-clips
    # are distinguishable in telemetry/books
    fp = hashlib.sha256(json.dumps(
        {"source_fp": source_fp, "shard_clips": int(shard_clips),
         "num_clips": len(entries)},
        sort_keys=True, separators=(",", ":")).encode()).hexdigest()
    return {"schema": MANIFEST_SCHEMA, "shard_clips": int(shard_clips),
            "source": dict(source, fingerprint=source_fp),
            "fingerprint": fp, "num_clips": len(entries), "shards": shards}


def build_manifest_from_lists(roots, shard_clips: int = 256
                              ) -> Dict[str, Any]:
    """Manifest from v3 list-file roots (``':'``-separated or a list)."""
    if isinstance(roots, str):
        roots = [r for r in roots.split(":") if r]
    roots = [os.fspath(r) for r in roots]
    lists = read_source_lists(roots)
    source = {"type": "lists", "roots": roots}
    return _finish(source, _lists_fingerprint(lists),
                   _entries_from_lists(lists), shard_clips)


def build_manifest_from_pack(pack_dir: str, shard_clips: int = 256
                             ) -> Dict[str, Any]:
    """Manifest from a packed cache's index; stale exactly when the pack
    is (the pack fingerprint IS the source fingerprint)."""
    index = load_index(pack_dir)
    entries: List[Entry] = [(kind, int(ri), name, int(num))
                            for kind, ri, name, num, _label
                            in index["clips"]]
    source = {"type": "pack", "pack_dir": os.fspath(pack_dir),
              "frames_per_clip": int(index["frames_per_clip"]),
              "sample_hw": [int(v) for v in index["sample_hw"]]}
    return _finish(source, index["fingerprint"], entries, shard_clips)


def save_manifest(path: str, manifest: Dict[str, Any]) -> None:
    """write → fsync → atomic rename (the pack_dataset idiom): a reader
    never sees a half-written manifest."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_manifest(path: str) -> Dict[str, Any]:
    """Read + structurally validate a manifest; loud on anything off."""
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise BackfillManifestStale(f"{path}: unreadable manifest ({e})")
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{path}: no backfill manifest (build one with "
            f"python -m deepfake_detection_tpu_torch.backfill.manifest)")
    missing = [k for k in _REQUIRED_KEYS if k not in manifest]
    if missing or manifest.get("schema") != MANIFEST_SCHEMA:
        raise BackfillManifestStale(
            f"{path}: manifest schema mismatch (schema "
            f"{manifest.get('schema')!r}, missing keys {missing}) — "
            f"rebuild the manifest")
    n = sum(len(s["clips"]) for s in manifest["shards"])
    if n != int(manifest["num_clips"]):
        raise BackfillManifestStale(
            f"{path}: shard table holds {n} clips but num_clips says "
            f"{manifest['num_clips']} — damaged manifest")
    seen = set()
    for s in manifest["shards"]:
        for kind, ri, name, _num in s["clips"]:
            key = (kind, int(ri), name)
            if key in seen:
                raise BackfillManifestStale(
                    f"{path}: clip {kind}/{name} (root {ri}) appears "
                    f"twice — books could never balance")
            seen.add(key)
    return manifest


def manifest_entries(manifest: Dict[str, Any],
                     shard_id: Optional[str] = None) -> Iterator[Entry]:
    """Entries of one shard (or the whole corpus) as typed tuples."""
    for s in manifest["shards"]:
        if shard_id is not None and s["id"] != shard_id:
            continue
        for kind, ri, name, num in s["clips"]:
            yield (kind, int(ri), name, int(num))


def verify_manifest_source(manifest: Dict[str, Any],
                           roots: Optional[Sequence[str]] = None,
                           pack_dir: Optional[str] = None) -> None:
    """Prove the live sources still are what the manifest was built from.

    Exactly one of ``roots``/``pack_dir`` must be given (what the runner
    was launched against); a fingerprint mismatch is a loud
    :class:`BackfillManifestStale` naming both sides.
    """
    src = manifest["source"]
    if pack_dir is not None:
        index = load_index(pack_dir)
        if index["fingerprint"] != src["fingerprint"]:
            raise BackfillManifestStale(
                f"{pack_dir}: pack fingerprint "
                f"{index['fingerprint'][:12]}… does not match the "
                f"manifest's source fingerprint "
                f"{src['fingerprint'][:12]}… — the pack was rebuilt "
                f"since the manifest; rebuild the manifest")
        return
    if roots is not None:
        if isinstance(roots, str):
            roots = [r for r in roots.split(":") if r]
        fp = _lists_fingerprint(read_source_lists(list(roots)))
        if fp != src["fingerprint"]:
            raise BackfillManifestStale(
                f"{roots}: source list files changed since the manifest "
                f"was built (fingerprint {fp[:12]}… vs manifest "
                f"{src['fingerprint'][:12]}…) — rebuild the manifest")
        return
    raise ValueError("verify_manifest_source needs roots or pack_dir")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write a manifest: over a pack's index with ``--packed``, else over
    the list files of the ``:``-separated roots."""
    p = argparse.ArgumentParser(
        description="build a dfd.backfill.manifest.v1 work manifest")
    p.add_argument("roots", help="v3 list roots, ':'-separated")
    p.add_argument("--manifest", required=True, help="output JSON path")
    p.add_argument("--packed", default="",
                   help="a pack of those roots: its index fixes the clips "
                        "and the fingerprint")
    p.add_argument("--shard-clips", type=int, default=256)
    args = p.parse_args(argv)
    m = (build_manifest_from_pack(args.packed, args.shard_clips)
         if args.packed else
         build_manifest_from_lists(args.roots, args.shard_clips))
    save_manifest(args.manifest, m)
    print(f"manifest {args.manifest}: {m['num_clips']} clips in "
          f"{len(m['shards'])} shards of {m['shard_clips']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
