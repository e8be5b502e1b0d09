"""The warm-start store: built kernel libraries and capture manifests.

The counterpart of ``deepfake_detection_tpu/serving/warmstart.py``.  The
JAX store parks serialized XLA executables; a CUDA graph cannot be
serialized, so this store holds what can be carried from one process (or
one checkout) to the next, content-addressed under ``root/`` by
``serving/warmkey.py``:

* **kernel libraries**: ``<key>.so`` (the library ``csrc/build.py`` built
  with nvcc) and ``<key>.json`` (the key fields, the payload's sha256,
  ``nvcc --version`` in full and the ptxas log).  A hit skips nvcc; the
  library is still held against its plain PyTorch versions by the kernel
  canary (``csrc/build.py``) before any function pointer is handed out.
* **capture manifests**: ``<key>.json`` per (model program, bucket, chans,
  wire, quant) with the golden-batch scores and the params fingerprint at
  save time.  There is no payload: the graph is always recaptured, and the
  engine's golden-batch canary holds the recapture's scores against the
  manifest's (bitwise under the same fingerprint).

Every file is written write → fsync → atomic rename, so a crashed writer
leaves a whole entry or none, and a temp file is never read.  ``load``
raises :class:`WarmstartMiss` with a reason (``absent``,
``manifest-unreadable``, ``key-mismatch``, ``payload-hash``,
``load-failed``); callers count it and build fresh.  ``save`` is
best-effort: a full disk logs and the process serves on.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
from typing import Any, Dict, Tuple

from . import warmkey

log = logging.getLogger(__name__)

__all__ = ["WarmstartMiss", "WarmStore"]


class WarmstartMiss(Exception):
    """Entry absent, foreign, corrupt or unloadable: count it, build
    fresh."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


class WarmStore:
    """Content-addressed store of kernel libraries and capture
    manifests."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def library_path(self, key: str) -> str:
        return os.path.join(self.root, key + ".so")

    def manifest_path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def _manifest(self, fields: Dict[str, Any]) -> Tuple[str, Dict]:
        """(key, manifest) of ``fields``, the manifest read and its echo of
        the fields checked."""
        key = warmkey.store_key(fields)
        mpath = self.manifest_path(key)
        if not os.path.exists(mpath):
            raise WarmstartMiss("absent", key[:12])
        try:
            manifest = warmkey.read_manifest(mpath)
        except (OSError, ValueError) as e:
            raise WarmstartMiss("manifest-unreadable", f"{key[:12]}: {e}")
        # a foreign file parked under this name: its manifest must echo
        # the exact fields the key was derived from
        if not isinstance(manifest, dict) or manifest.get("fields") != fields:
            raise WarmstartMiss("key-mismatch", key[:12])
        return key, manifest

    # -- kernel libraries ----------------------------------------------
    def load_library(self, fields: Dict[str, Any], dest: str
                     ) -> Dict[str, Any]:
        """Place the stored library of ``fields`` at ``dest`` (atomically)
        and prove that the dynamic loader takes it; returns its manifest.
        The payload's sha256 is checked before ``dest`` is written, so a
        corrupt library never reaches ``dlopen``.  Raises
        :class:`WarmstartMiss`."""
        key, manifest = self._manifest(fields)
        try:
            with open(self.library_path(key), "rb") as f:
                blob = f.read()
        except OSError as e:
            raise WarmstartMiss("absent", f"{key[:12]}: {e}")
        if hashlib.sha256(blob).hexdigest() != manifest.get("sha256"):
            raise WarmstartMiss("payload-hash", key[:12])
        warmkey.write_atomic(dest, blob)
        try:
            ctypes.CDLL(dest)
        except OSError as e:
            try:
                os.unlink(dest)
            except OSError:
                pass
            raise WarmstartMiss("load-failed", f"{key[:12]}: {e}")
        return manifest

    def save_library(self, fields: Dict[str, Any], path: str, *,
                     nvcc_version: str, ptxas_log: str) -> bool:
        """Store the library built at ``path`` under ``fields``' key
        (payload first, then its manifest); best-effort."""
        key = warmkey.store_key(fields)
        try:
            with open(path, "rb") as f:
                blob = f.read()
            warmkey.write_atomic(self.library_path(key), blob)
            warmkey.write_manifest(self.manifest_path(key), {
                "schema": warmkey.WARMSTART_SCHEMA, "kind": "library",
                "fields": fields, "key": key,
                "sha256": hashlib.sha256(blob).hexdigest(),
                "payload_bytes": len(blob), "nvcc_version": nvcc_version,
                "ptxas_log": ptxas_log})
            return True
        except OSError as e:           # a full disk never stops a build
            log.warning("warmstart: saving library %s failed: %s", key[:12],
                        e)
            return False

    # -- capture manifests ---------------------------------------------
    def load(self, fields: Dict[str, Any]) -> Dict[str, Any]:
        """The capture manifest of ``fields``; raises
        :class:`WarmstartMiss`.  The caller recaptures and MUST run the
        golden-batch canary before the graph serves."""
        return self._manifest(fields)[1]

    def save(self, fields: Dict[str, Any], *, golden_scores: Any,
             params_fingerprint: str) -> bool:
        """Write the capture manifest of ``fields``; best-effort."""
        key = warmkey.store_key(fields)
        try:
            warmkey.write_manifest(self.manifest_path(key), {
                "schema": warmkey.WARMSTART_SCHEMA, "kind": "capture",
                "fields": fields, "key": key,
                "params_fingerprint": str(params_fingerprint),
                "golden_scores": warmkey.encode_array(golden_scores)})
            return True
        except OSError as e:
            log.warning("warmstart: saving manifest %s failed: %s",
                        key[:12], e)
            return False

    def refresh_manifest(self, fields: Dict[str, Any], *, golden_scores: Any,
                         params_fingerprint: str) -> None:
        """Re-stamp an entry's manifest for the current checkpoint (after a
        fingerprint-skewed entry passed the canary), so the next
        same-checkpoint start gets the bitwise gate back."""
        key = warmkey.store_key(fields)
        try:
            manifest = warmkey.read_manifest(self.manifest_path(key))
            manifest["params_fingerprint"] = str(params_fingerprint)
            manifest["golden_scores"] = warmkey.encode_array(golden_scores)
            warmkey.write_manifest(self.manifest_path(key), manifest)
        except (OSError, ValueError) as e:  # pragma: no cover - best effort
            log.warning("warmstart: manifest refresh of %s failed: %s",
                        key[:12], e)
