"""Frame-once crop rings: preallocated canvas rows, per-crop digests,
and zero-copy window payloads.

The streaming hot path used to copy every crop up to ``img_num/hop``
times: once into a standalone canvas at ingest, once per overlapping
window into the ``np.concatenate`` payload, and once more into the
engine's batch slab.  This module makes the frame lifecycle
**write-once, gather-once**:

* :class:`CanvasRing` — a per-track preallocated ``(capacity, H, W, 3)``
  uint8 pool.  ``prepare_canvas`` geometry is written straight into an
  acquired row at ingest (the ONE per-frame copy) and the row is
  refcounted: the windower buffer holds one reference, every in-flight
  window that still needs the bytes holds another, and the row returns
  to the freelist at zero.  Pool exhaustion (pathological scoring lag)
  degrades to counted standalone allocations — never corruption, never
  a stall.
* :func:`frame_digest` — sha256 over the canonical canvas (dtype, shape,
  bytes — the per-frame contribution of ``cache.content.content_hash``),
  computed ONCE per crop and reused by every overlapping window.
* :func:`window_key` — the window's cache identity: a domain-separated
  digest-of-digests in frame order, so keying a window costs hashing
  ``img_num * 32`` bytes instead of re-hashing megapixels.
* :class:`FrameStack` — a window payload that is never materialized:
  it presents ``shape``/``ndim``/``dtype`` like the channel-concatenated
  sample it stands for, and the engine's ``_pad_batch`` calls
  :meth:`FrameStack.write_into` to gather the frames directly into the
  batch slab — one memcpy total, after which the ring rows are released.

Counterpart of ``deepfake_detection_tpu/streaming/ring.py``, kept
bitwise: the digests and window keys are the verdict cache's keys, so
the two packages key the same window the same way.  numpy + hashlib +
threading only.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CanvasRing", "FrameRef", "RingLease", "FrameStack",
           "frame_digest", "window_key"]

_WINDOW_KEY_DOMAIN = b"dfd.stream.window.v1"


def frame_digest(canvas: np.ndarray) -> bytes:
    """sha256 over the canonical canvas: dtype tag, shape tag, raw bytes
    (the per-frame structure of ``cache.content.content_hash``).  For a
    C-contiguous canvas the bytes are hashed via the buffer protocol —
    no copy."""
    a = canvas if canvas.flags.c_contiguous else np.ascontiguousarray(canvas)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a)
    return h.digest()


def window_key(digests: Sequence[bytes]) -> str:
    """Window content identity from cached per-crop digests: a domain-
    separated digest-of-digests in frame order.  Two windows share a key
    iff they hold the same canvases in the same order — the dedup
    contract ``tests`` pin against a from-scratch recomputation."""
    h = hashlib.sha256(_WINDOW_KEY_DOMAIN)
    for d in digests:
        h.update(d)
    return h.hexdigest()


class FrameRef:
    """Lifetime handle for one canvas: a refcounted pooled row, or a
    standalone array (``ring is None``) whose lifetime the GC manages —
    ``incref``/``decref`` are then no-ops."""

    __slots__ = ("ring", "row", "canvas", "digest")

    def __init__(self, canvas: np.ndarray, digest: Optional[bytes] = None,
                 ring: Optional["CanvasRing"] = None, row: int = -1):
        self.canvas = canvas
        self.digest = digest
        self.ring = ring
        self.row = row

    def incref(self) -> None:
        if self.ring is not None:
            self.ring.incref(self.row)

    def decref(self) -> None:
        if self.ring is not None:
            self.ring.decref(self.row)


class CanvasRing:
    """Preallocated pool of ``capacity`` contiguous ``(H, W, 3)`` uint8
    canvas rows with per-row refcounts.

    ``acquire`` hands out a row at refcount 1 (the windower buffer's
    reference); windows pin rows with ``incref`` and release them after
    the engine's gather.  An exhausted pool (every row pinned by
    in-flight windows) falls back to counted standalone rows rather
    than blocking ingest or recycling pinned bytes.
    """

    def __init__(self, capacity: int, size: int):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.buf = np.zeros((int(capacity), int(size), int(size), 3),
                            np.uint8)
        self._free = list(range(int(capacity) - 1, -1, -1))
        self._refs = [0] * int(capacity)
        self._lock = threading.Lock()
        self.overflow_total = 0

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    def free_rows(self) -> int:
        with self._lock:
            return len(self._free)

    def acquire(self) -> FrameRef:
        """A writable canvas row at refcount 1.  Falls back to a counted
        standalone allocation when every pooled row is pinned."""
        with self._lock:
            if self._free:
                row = self._free.pop()
                self._refs[row] = 1
                return FrameRef(self.buf[row], None, self, row)
            self.overflow_total += 1
        size = self.buf.shape[1]
        return FrameRef(np.zeros((size, size, 3), np.uint8))

    def incref(self, row: int) -> None:
        with self._lock:
            self._refs[row] += 1

    def decref(self, row: int) -> None:
        with self._lock:
            n = self._refs[row] - 1
            self._refs[row] = n
            if n == 0:
                self._free.append(row)
            elif n < 0:                              # pragma: no cover
                # a double-release is a bug upstream; clamp so the row
                # can still recirculate instead of leaking forever
                self._refs[row] = 0


class RingLease:
    """The pins one in-flight window holds on its ring rows.  ``release``
    is idempotent — the engine's gather consumes it on the staging
    thread, and the dispatcher's terminal paths (drop/shed/fail/cache
    hit) release it for windows that never staged."""

    __slots__ = ("_refs",)
    _swap_lock = threading.Lock()

    def __init__(self, refs: Sequence[FrameRef]):
        self._refs: Optional[List[FrameRef]] = list(refs)

    def release(self) -> None:
        with RingLease._swap_lock:
            refs, self._refs = self._refs, None
        if refs:
            for r in refs:
                r.decref()


class FrameStack:
    """A window payload that is never materialized host-side.

    Presents the ``shape``/``ndim``/``dtype`` of the channel-concatenated
    sample (``(H, W, 3*img_num)``) so the micro-batcher and the engine's
    bucket grouping treat it like an ndarray, but the pixel bytes stay in
    the ring until the engine's ``_pad_batch`` calls :meth:`write_into`
    on its batch slab — the single gather-memcpy of the window's life.

    ``norm=(mean, std)`` selects the float32 wire: each frame is written
    as ``(f.astype(float32) - mean) / std``, the exact per-frame
    expression of ``params.normalize_concat`` (bit-identical scores).
    Without ``norm`` the uint8 wire ships raw channel-concat bytes.
    """

    __slots__ = ("frames", "shape", "ndim", "dtype", "_norm",
                 "_on_consumed")

    def __init__(self, frames: Sequence[np.ndarray],
                 norm: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 on_consumed: Optional[Callable[[], None]] = None):
        if not frames:
            raise ValueError("FrameStack needs at least one frame")
        h, w = frames[0].shape[:2]
        self.frames = list(frames)
        self.shape = (h, w, 3 * len(self.frames))
        self.ndim = 3
        self._norm = norm
        self.dtype = np.dtype(np.float32) if norm is not None \
            else np.dtype(frames[0].dtype)
        self._on_consumed = on_consumed

    # ------------------------------------------------------------------
    def _gather(self, out: np.ndarray) -> None:
        norm = self._norm
        for k, f in enumerate(self.frames):
            sl = out[..., 3 * k:3 * (k + 1)]
            if norm is None:
                sl[...] = f
            else:
                mean, std = norm
                sl[...] = (f.astype(np.float32) - mean) / std

    def write_into(self, out: np.ndarray) -> None:
        """Gather the frames into ``out`` (the engine's batch-slab row)
        and release the ring pins — the payload is consumed."""
        self._gather(out)
        cb, self._on_consumed = self._on_consumed, None
        if cb is not None:
            cb()

    def materialize(self) -> np.ndarray:
        """The sample as a standalone ndarray (tests, diagnostics) —
        does NOT consume the payload or release pins."""
        out = np.empty(self.shape, self.dtype)
        self._gather(out)
        return out

    def __array__(self, dtype=None) -> np.ndarray:
        a = self.materialize()
        return a if dtype is None else a.astype(dtype, copy=False)
