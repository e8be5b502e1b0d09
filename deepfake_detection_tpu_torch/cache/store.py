"""The bounded verdict store (LRU + TTL + near-dup band index) and the
in-flight coalescing table.

``VerdictCache`` is value-agnostic: the serving batcher stores score
rows, the fleet router stores whole HTTP response bodies under a
synthetic "edge" model whose fingerprint is the fleet weights-epoch.
One lock guards everything — probes are a dict hit plus an OrderedDict
move, far below the ~0.6 ms/clip device floor they replace.

The near-dup index is multi-index Hamming: each 64-bit dHash splits
into four 16-bit bands; by pigeonhole, any candidate within Hamming
radius ≤ 3 of the probe matches it exactly in at least one band, so a
probe is 4 bucket lookups + a handful of popcounts, never a scan.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import (Any, Callable, Dict, Hashable, List, Optional, Set,
                    Tuple)

from .content import hamming64

__all__ = ["VerdictCache", "SingleFlight"]

_BANDS = 4
_BAND_BITS = 16
_BAND_MASK = (1 << _BAND_BITS) - 1

Key = Tuple[str, str, str]          # (content_hash, model_id, fingerprint)
PHash = Tuple[int, int]             # (dhash64, ahash64)


class _Entry:
    __slots__ = ("value", "phash", "deadline")

    def __init__(self, value: Any, phash: Optional[PHash],
                 deadline: float) -> None:
        self.value = value
        self.phash = phash
        self.deadline = deadline


class VerdictCache:
    """Bounded LRU+TTL store keyed ``(content_hash, model_id,
    fingerprint)``.

    * ``capacity`` bounds entries; inserting past it evicts LRU (counted
      via ``on_evicted``, never silent).
    * ``ttl_s`` bounds staleness; an expired entry found by a probe is
      removed and counted via ``on_expired`` — expiry is lazy, there is
      no sweeper thread.
    * ``near_dup`` enables the dHash band index; near probes only ever
      run after an exact miss and hits are counted separately by the
      caller (never conflated with exact hits).
    * ``clock`` is injected for tests (monotonic seconds).

    Invalidation-on-reload needs no sweep either: a reload bumps the
    fingerprint, so old entries simply can never be addressed again —
    ``purge_model`` exists to reclaim their memory eagerly and count
    them.
    """

    def __init__(self, capacity: int, ttl_s: float, *,
                 near_dup: bool = False, near_radius: int = 3,
                 clock: Callable[[], float] = time.monotonic,
                 on_expired: Optional[Callable[[int], None]] = None,
                 on_evicted: Optional[Callable[[int], None]] = None) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        if not 0 <= near_radius <= 8:
            raise ValueError(
                f"near_radius must be in [0, 8], got {near_radius}")
        self.capacity = int(capacity)
        self.ttl_s = float(ttl_s)
        self.near_dup = bool(near_dup)
        self.near_radius = int(near_radius)
        self._clock = clock
        self._on_expired = on_expired
        self._on_evicted = on_evicted
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Key, _Entry]" = OrderedDict()
        # (model_id, fingerprint, band_index, band_value) -> keys
        self._bands: Dict[Tuple[str, str, int, int], Set[Key]] = {}

    # ------------------------------------------------------------- internals

    def _band_keys(self, key: Key, dhash: int):
        model_id, fp = key[1], key[2]
        for i in range(_BANDS):
            yield (model_id, fp, i, (dhash >> (_BAND_BITS * i)) & _BAND_MASK)

    def _index_add(self, key: Key, phash: Optional[PHash]) -> None:
        if phash is None:
            return
        for bk in self._band_keys(key, phash[0]):
            self._bands.setdefault(bk, set()).add(key)

    def _index_remove(self, key: Key, phash: Optional[PHash]) -> None:
        if phash is None:
            return
        for bk in self._band_keys(key, phash[0]):
            bucket = self._bands.get(bk)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._bands[bk]

    def _remove(self, key: Key) -> None:
        e = self._entries.pop(key)
        self._index_remove(key, e.phash)

    def _expire(self, keys: List[Key]) -> None:
        for key in keys:
            self._remove(key)
        if keys and self._on_expired is not None:
            self._on_expired(len(keys))

    # --------------------------------------------------------------- probes

    def get(self, content_hash: str, model_id: str,
            fingerprint: str) -> Optional[Any]:
        """Exact probe; None on miss.  Hits refresh LRU recency."""
        key = (content_hash, model_id, fingerprint)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if e.deadline <= self._clock():
                self._expire([key])
                return None
            self._entries.move_to_end(key)
            return e.value

    def get_near(self, phash: PHash, model_id: str,
                 fingerprint: str) -> Optional[Tuple[Any, int]]:
        """Near-dup probe: best in-radius candidate as ``(value, dist)``.

        Both the dHash and aHash distances must sit within the radius —
        the aHash check cuts false positives the gradient hash alone
        lets through (its caveats are documented in the README: a
        near-hit is a *different* clip's verdict by construction).
        """
        if not self.near_dup:
            return None
        dhash, ahash = phash
        with self._lock:
            now = self._clock()
            candidates: Set[Key] = set()
            for i in range(_BANDS):
                bk = (model_id, fingerprint, i,
                      (dhash >> (_BAND_BITS * i)) & _BAND_MASK)
                candidates |= self._bands.get(bk, set())
            best_key, best_dist = None, None
            dead: List[Key] = []
            for key in candidates:
                e = self._entries.get(key)
                if e is None or e.phash is None:
                    continue
                if e.deadline <= now:
                    dead.append(key)
                    continue
                d = hamming64(dhash, e.phash[0])
                if d > self.near_radius:
                    continue
                if hamming64(ahash, e.phash[1]) > self.near_radius:
                    continue
                if best_dist is None or d < best_dist:
                    best_key, best_dist = key, d
            self._expire(dead)
            if best_key is None:
                return None
            self._entries.move_to_end(best_key)
            return self._entries[best_key].value, int(best_dist)

    # ------------------------------------------------------------ mutations

    def put(self, content_hash: str, model_id: str, fingerprint: str,
            value: Any, *, phash: Optional[PHash] = None) -> None:
        key = (content_hash, model_id, fingerprint)
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._index_remove(key, old.phash)
                del self._entries[key]
            self._entries[key] = _Entry(
                value, phash if self.near_dup else None,
                self._clock() + self.ttl_s)
            if self.near_dup:
                self._index_add(key, phash)
            evicted = 0
            while len(self._entries) > self.capacity:
                victim, _ = next(iter(self._entries.items()))
                self._remove(victim)
                evicted += 1
            if evicted and self._on_evicted is not None:
                self._on_evicted(evicted)

    def purge_model(self, model_id: str, *,
                    keep_fingerprint: Optional[str] = None) -> int:
        """Drop every entry for ``model_id`` whose fingerprint differs
        from ``keep_fingerprint``; returns how many were dropped.

        Called after a reload commit: the bumped fingerprint already
        orphans old entries addressably, this reclaims their memory and
        lets the caller book them as invalidated.
        """
        with self._lock:
            doomed = [k for k in self._entries
                      if k[1] == model_id and k[2] != keep_fingerprint]
            for key in doomed:
                self._remove(key)
            return len(doomed)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bands.clear()
            return n

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def __len__(self) -> int:
        return self.size()


class SingleFlight:
    """In-flight coalescing: N concurrent requests for one key dispatch
    ONE inference and all N ride the result.

    The first caller for a key becomes the *leader* (``lead_or_follow``
    returns True) and must eventually ``pop`` the key — on resolution or
    on failing to enqueue — handing back every follower that attached in
    the meantime.  Followers attached after the pop simply elect a new
    leader; there is no window where a follower can be stranded, because
    attach and pop serialize on one lock.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._waiting: Dict[Hashable, List[Any]] = {}

    def lead_or_follow(self, key: Hashable, follower: Any) -> bool:
        """True → caller is the leader (``follower`` is NOT registered);
        False → ``follower`` was attached to the existing leader."""
        with self._lock:
            if key in self._waiting:
                self._waiting[key].append(follower)
                return False
            self._waiting[key] = []
            return True

    def pop(self, key: Hashable) -> List[Any]:
        """Detach and return all followers for ``key`` (leader's duty,
        exactly once per lead)."""
        with self._lock:
            return self._waiting.pop(key, [])

    def depth(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._waiting.values())
