"""Content-addressed verdict cache: the dedup tier.

A copy of ``deepfake_detection_tpu/cache`` (numpy and the standard
library only).

At production scale the request distribution is Zipfian — the same
re-shared clip arrives over and over, and without this tier every copy
pays a full forward pass.  In the JAX package it is shared by three
consumers (the port has the first so far):

* the serving batcher's pre-dispatch probe (hit resolves a request
  without it ever entering a bucket; miss populates on score),
* the fleet router's optional edge probe (both data planes), and
* the backfill dedup pass over pack shards.

Keying is ``(content_hash, model_id, checkpoint_fingerprint)`` — the
content hash is taken over the *canonical uint8 canvas* (after
``params.prepare_canvas``) so byte-identical re-uploads at any
container/encoding collide, and the fingerprint is the engine's weight
identity so a hot reload or quantized swap can never serve a stale
verdict: the reload commit bumps the fingerprint atomically and old
entries are orphaned by construction.
"""

from .content import (ahash64, clip_phash, content_hash, dhash64,
                      hamming64, tree_fingerprint)
from .store import SingleFlight, VerdictCache

__all__ = [
    "VerdictCache",
    "SingleFlight",
    "content_hash",
    "clip_phash",
    "dhash64",
    "ahash64",
    "hamming64",
    "tree_fingerprint",
]
