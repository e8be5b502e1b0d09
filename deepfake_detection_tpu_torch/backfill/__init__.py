"""Corpus-scale offline backfill: leased work shards, exact books.

The counterpart of ``deepfake_detection_tpu/backfill``, whose formats it
keeps: a sharded work **manifest** (clips grouped into fixed-size
shards, built from the v3 lists or a pack) is mapped over by N
independent worker processes that **lease** shards through atomic
filesystem operations in a shared run directory, score each shard
through one captured CUDA graph fed double-buffered
(``runners/backfill.py``), and append schema-versioned
``dfd.backfill.verdict.v1`` JSONL per shard with a per-shard done
marker — so a SIGTERM (or a dead host) at any point resumes at shard
granularity with exact books: ``manifest clips == scored + failed +
skipped_dup``, no clip scored twice, none missing.

manifest, lease, writer and source need numpy and the standard library
only; ``runners/backfill.py`` holds the device.
"""

from .lease import LeaseDir
from .manifest import (BackfillManifestStale, MANIFEST_SCHEMA,
                       build_manifest_from_lists, build_manifest_from_pack,
                       load_manifest, manifest_entries, save_manifest,
                       verify_manifest_source)
from .writer import (VERDICT_SCHEMA, ShardVerdictWriter, collect_books,
                     read_verdicts)

__all__ = [
    "BackfillManifestStale", "LeaseDir", "MANIFEST_SCHEMA",
    "ShardVerdictWriter", "VERDICT_SCHEMA", "build_manifest_from_lists",
    "build_manifest_from_pack", "collect_books", "load_manifest",
    "manifest_entries", "read_verdicts", "save_manifest",
    "verify_manifest_source",
]
