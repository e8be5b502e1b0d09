"""Content addressing: exact and perceptual hashes over canonical
canvases, plus the params-tree fingerprint that keys weight identity.

Everything here is numpy + hashlib, no I/O.  The exact hash is
taken AFTER canonicalization (``params.prepare_canvas``'s uint8 HWC
canvas) so the same clip re-encoded at a different quality/container
still collides once decode+resize has normalized it; two uploads that
decode to different pixels are different content by definition and only
the (opt-in) perceptual index may identify them.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence, Tuple

import numpy as np

__all__ = [
    "content_hash",
    "dhash64",
    "ahash64",
    "clip_phash",
    "hamming64",
    "tree_fingerprint",
]


def content_hash(canvases: Sequence[np.ndarray]) -> str:
    """Exact content address: sha256 over dtype/shape/bytes of each
    canonical canvas, in frame order.

    Frame order is part of the identity (a reversed clip is different
    content), as are dtype and shape (a 380px canvas of the same clip is
    a different key — it feeds a different model entry anyway).
    """
    h = hashlib.sha256()
    for c in canvases:
        a = np.ascontiguousarray(c)
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _gray_grid(canvas: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """Block-mean downsample to a ``gh x gw`` grayscale grid.

    Pure-numpy: channel mean, crop to block multiples, reshape-mean.
    Small inputs are edge-padded up to the grid size first.
    """
    a = np.asarray(canvas, dtype=np.float64)
    if a.ndim == 3:
        a = a.mean(axis=2)
    if a.ndim != 2:
        raise ValueError(f"canvas must be HW or HWC, got shape {a.shape}")
    h, w = a.shape
    if h < gh or w < gw:
        a = np.pad(a, ((0, max(0, gh - h)), (0, max(0, gw - w))),
                   mode="edge")
        h, w = a.shape
    h2, w2 = (h // gh) * gh, (w // gw) * gw
    a = a[:h2, :w2]
    return a.reshape(gh, h2 // gh, gw, w2 // gw).mean(axis=(1, 3))


def _pack_bits(bits: np.ndarray) -> int:
    v = 0
    for b in bits.reshape(-1):
        v = (v << 1) | int(b)
    return v


def dhash64(canvas: np.ndarray) -> int:
    """64-bit difference hash: 8x9 block-mean grid, bit = right > left.

    Gradient-based, so robust to global brightness/contrast shifts —
    the classic near-dup workhorse.
    """
    g = _gray_grid(canvas, 8, 9)
    return _pack_bits(g[:, 1:] > g[:, :-1])


def ahash64(canvas: np.ndarray) -> int:
    """64-bit average hash: 8x8 block-mean grid, bit = cell > mean."""
    g = _gray_grid(canvas, 8, 8)
    return _pack_bits(g > g.mean())


def clip_phash(canvases: Sequence[np.ndarray]) -> Tuple[int, int]:
    """Perceptual identity of a multi-frame clip: ``(dhash, ahash)``
    over the per-frame grids averaged across frames.

    Averaging grids (not hashing frame 0) keeps the identity stable
    under small temporal offsets while staying deterministic.
    """
    if not canvases:
        raise ValueError("clip_phash needs at least one canvas")
    d = np.mean([_gray_grid(c, 8, 9) for c in canvases], axis=0)
    a = np.mean([_gray_grid(c, 8, 8) for c in canvases], axis=0)
    return _pack_bits(d[:, 1:] > d[:, :-1]), _pack_bits(a > a.mean())


def hamming64(a: int, b: int) -> int:
    """Hamming distance between two 64-bit hashes."""
    return bin((a ^ b) & 0xFFFFFFFFFFFFFFFF).count("1")


def tree_fingerprint(leaves: Iterable[Tuple[str, np.ndarray]],
                     extra: Sequence[str] = ()) -> str:
    """Stable hex digest of a flattened params tree.

    ``leaves`` is ``(path, host_array)`` pairs in a deterministic order
    (the engine hands its state dict here, key by key, as plain
    numpy).  ``extra`` folds in
    out-of-tree identity such as the serving dtype — an f32→bf16 swap of
    the same weights scores differently and must not share verdicts.
    """
    h = hashlib.sha256()
    for tag in extra:
        h.update(str(tag).encode())
        h.update(b"\x00")
    for path, arr in leaves:
        a = np.ascontiguousarray(arr)
        h.update(str(path).encode())
        h.update(b"\x1f")
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
