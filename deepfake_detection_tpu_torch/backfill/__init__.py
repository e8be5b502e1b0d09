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
only; ``runners/backfill.py`` holds the device.  PEP-562 lazy exports:
importing the package loads no submodule, so the fleet's autoscaler takes
``lease.LeaseDir`` in a process that never imports torch.
"""

from __future__ import annotations

_LAZY = {
    "LeaseDir": "lease",
    "BackfillManifestStale": "manifest", "MANIFEST_SCHEMA": "manifest",
    "build_manifest_from_lists": "manifest",
    "build_manifest_from_pack": "manifest", "load_manifest": "manifest",
    "manifest_entries": "manifest", "save_manifest": "manifest",
    "verify_manifest_source": "manifest",
    "VERDICT_SCHEMA": "writer", "ShardVerdictWriter": "writer",
    "collect_books": "writer", "read_verdicts": "writer",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
