"""Face localization + greedy-IoU tracking for the streaming pipeline.

Everything upstream of this repo assumed pre-extracted face crops; a live
stream delivers whole frames, so the pipeline needs (a) a *localizer*
that proposes face boxes per frame and (b) a *tracker* that strings those
boxes into stable per-face tracks the temporal windower can batch over.

The localizer is a pluggable interface because the detector model is a
deployment choice, not an architecture one:

* :class:`FullFrameLocalizer` (``"full_frame"``) — the deterministic
  built-in: one box covering the whole frame.  This reproduces today's
  pre-cropped assumption exactly (crop == frame, so window payloads are
  bit-identical to the CLI preprocess of the same frames) and is the mode
  every parity test and bench runs.
* ``"callable:<module>:<attr>"`` — the model-backed adapter slot: any
  importable ``frame -> [(box, score), ...]`` function (an ONNX/torch face
  detector, a remote detection service client) plugs in without touching
  this module.  :func:`register_localizer` does the same for in-process
  factories.

The tracker is deliberately classical (greedy IoU association + EMA box
smoothing + birth/coast/death lifecycle — the SORT recipe minus the
Kalman filter, which EMA approximates for slow head motion): it is
deterministic given its inputs, runs in microseconds per frame on the
ingest thread, and its failure mode under missed detections is *coasting*
(keep scoring the last known box) rather than track churn, which is what
the per-track verdict EMA wants.

Counterpart of ``deepfake_detection_tpu/streaming/tracker.py``; numpy
only, so unit/property tests stay sub-second.  A ``callable:`` spec is
imported by name when a session starts, never by this module.
"""

from __future__ import annotations

import importlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Box", "Detection", "iou", "clip_box", "crop_box",
           "FaceLocalizer", "FullFrameLocalizer", "CallableLocalizer",
           "register_localizer", "make_localizer", "localizer_names",
           "Track", "TrackerUpdate", "GreedyIouTracker"]

#: (x1, y1, x2, y2) in pixels, half-open, x right / y down
Box = Tuple[float, float, float, float]
#: one localizer proposal: (box, confidence in [0, 1])
Detection = Tuple[Box, float]


def iou(a: Sequence[float], b: Sequence[float]) -> float:
    """Intersection-over-union of two (x1, y1, x2, y2) boxes."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    if inter <= 0.0:
        return 0.0
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0.0 else 0.0


def clip_box(box: Sequence[float], width: int, height: int) -> Box:
    x1 = min(max(box[0], 0.0), float(width))
    y1 = min(max(box[1], 0.0), float(height))
    x2 = min(max(box[2], x1), float(width))
    y2 = min(max(box[3], y1), float(height))
    return (x1, y1, x2, y2)


def crop_box(frame: np.ndarray, box: Sequence[float],
             margin: float = 0.0) -> np.ndarray:
    """Extract the (margin-expanded, clamped, integer-rounded) box from an
    (H, W, C) frame as a view.

    A full-frame box with any margin crops back to the exact frame (the
    expansion clamps away), which is what makes the ``full_frame``
    localizer's pipeline bit-identical to the pre-cropped CLI path.
    """
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = box
    if margin:
        mx = (x2 - x1) * margin
        my = (y2 - y1) * margin
        x1, y1, x2, y2 = x1 - mx, y1 - my, x2 + mx, y2 + my
    x1, y1, x2, y2 = clip_box((x1, y1, x2, y2), w, h)
    # integer-round, then force ≥1 px in both dims even for a degenerate
    # box at the far edge (a jittering detector can propose x1 == w; a
    # 0-width crop would crash params.resize downstream)
    xi1 = min(int(np.floor(x1)), w - 1) if w else 0
    yi1 = min(int(np.floor(y1)), h - 1) if h else 0
    xi2 = min(max(int(np.ceil(x2)), xi1 + 1), w)
    yi2 = min(max(int(np.ceil(y2)), yi1 + 1), h)
    return frame[yi1:yi2, xi1:xi2]


# ---------------------------------------------------------------------------
# Localizer interface + registry
# ---------------------------------------------------------------------------

class FaceLocalizer:
    """``frame -> [(box, score), ...]`` with a stable ``name`` for status
    surfaces.  Implementations must be deterministic per frame (the
    tracker and every downstream parity property assume it)."""

    name = "base"

    def localize(self, frame: np.ndarray) -> List[Detection]:
        raise NotImplementedError


class FullFrameLocalizer(FaceLocalizer):
    """One box covering the whole frame — the pre-cropped-input mode."""

    name = "full_frame"

    def localize(self, frame: np.ndarray) -> List[Detection]:
        h, w = frame.shape[:2]
        return [((0.0, 0.0, float(w), float(h)), 1.0)]


class CallableLocalizer(FaceLocalizer):
    """Adapter wrapping any ``frame -> [(box, score), ...]`` callable —
    the slot a model-backed face detector plugs into."""

    def __init__(self, fn: Callable[[np.ndarray], List[Detection]],
                 name: str = "callable"):
        self._fn = fn
        self.name = name

    def localize(self, frame: np.ndarray) -> List[Detection]:
        return [(tuple(float(c) for c in box), float(score))
                for box, score in self._fn(frame)]


_REGISTRY: Dict[str, Callable[[], FaceLocalizer]] = {
    "full_frame": FullFrameLocalizer,
}
_registry_lock = threading.Lock()


def register_localizer(name: str,
                       factory: Callable[[], FaceLocalizer]) -> None:
    with _registry_lock:
        _REGISTRY[name] = factory


def localizer_names() -> List[str]:
    with _registry_lock:
        return sorted(_REGISTRY)


def make_localizer(spec: str) -> FaceLocalizer:
    """Resolve a localizer spec: a registry name, or
    ``callable:<module>:<attr>`` importing a detector function."""
    with _registry_lock:
        factory = _REGISTRY.get(spec)
    if factory is not None:
        return factory()
    if spec.startswith("callable:"):
        mod_name, _, attr = spec[len("callable:"):].partition(":")
        if not mod_name or not attr:
            raise ValueError(
                f"localizer spec {spec!r} must be callable:<module>:<attr>")
        fn = getattr(importlib.import_module(mod_name), attr)
        return CallableLocalizer(fn, name=spec)
    raise ValueError(f"unknown localizer {spec!r} "
                     f"(known: {localizer_names()} or callable:mod:attr)")


# ---------------------------------------------------------------------------
# Tracks
# ---------------------------------------------------------------------------

class Track:
    """One face across frames: EMA-smoothed box + lifecycle counters."""

    __slots__ = ("id", "box", "score", "hits", "misses", "born_frame",
                 "last_frame", "windows_scored")

    def __init__(self, track_id: int, box: Box, score: float,
                 frame_idx: int):
        self.id = track_id
        self.box: Box = tuple(float(c) for c in box)
        self.score = float(score)
        self.hits = 1
        self.misses = 0
        self.born_frame = int(frame_idx)
        self.last_frame = int(frame_idx)
        self.windows_scored = 0

    @property
    def coasting(self) -> bool:
        return self.misses > 0

    def snapshot(self) -> Dict[str, Any]:
        return {"id": self.id, "box": [round(c, 2) for c in self.box],
                "hits": self.hits, "misses": self.misses,
                "born_frame": self.born_frame,
                "last_frame": self.last_frame,
                "coasting": self.coasting}

    # -- durability: FULL precision (snapshot() rounds for display) ----
    def state_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "box": list(self.box), "score": self.score,
                "hits": self.hits, "misses": self.misses,
                "born_frame": self.born_frame,
                "last_frame": self.last_frame,
                "windows_scored": self.windows_scored}

    @classmethod
    def from_state_dict(cls, d: Dict[str, Any]) -> "Track":
        t = cls(int(d["id"]), tuple(float(c) for c in d["box"]),
                float(d["score"]), int(d["born_frame"]))
        t.hits = int(d["hits"])
        t.misses = int(d["misses"])
        t.last_frame = int(d["last_frame"])
        t.windows_scored = int(d["windows_scored"])
        return t


class TrackerUpdate:
    """Result of one tracker step.  ``born`` lists EVERY new track
    (the birth ledger must balance against deaths); ``fresh`` additionally
    gates on ``min_hits`` confirmation."""

    __slots__ = ("matched", "born", "coasting", "died", "confirmed_born")

    def __init__(self, matched: List[Track], born: List[Track],
                 coasting: List[Track], died: List[Track],
                 confirmed_born: Optional[List[Track]] = None):
        self.matched = matched
        self.born = born
        self.coasting = coasting
        self.died = died
        self.confirmed_born = born if confirmed_born is None \
            else confirmed_born

    @property
    def fresh(self) -> List[Track]:
        """Tracks with a REAL detection this frame (matched, or born
        AND past min_hits confirmation) — the ones whose crop should
        enter the temporal window."""
        return self.matched + self.confirmed_born


class GreedyIouTracker:
    """Greedy IoU association with EMA box smoothing and a
    birth/coast/death lifecycle.

    * **association**: all (track, detection) pairs with IoU ≥ ``iou_min``
      are matched greedily in descending-IoU order (ties broken by track
      id then detection index, so the assignment is deterministic);
    * **smoothing**: a matched track's box moves by EMA —
      ``box = ema_alpha·det + (1-ema_alpha)·box`` — damping detector
      jitter so crops (and therefore window scores) are stable;
    * **coast**: an unmatched track keeps its last box for up to
      ``max_coast`` consecutive misses (detector flicker must not kill a
      track mid-window);
    * **death**: past ``max_coast`` misses the track is retired and
      reported in ``died`` so the windower/verdict state can be dropped;
    * **birth**: unmatched detections start new tracks; a track only
      counts as *confirmed* (``fresh``/windowable) after ``min_hits``
      matches, filtering one-frame false positives when a real detector
      is plugged in (``min_hits=1`` keeps the full-frame path immediate).
    """

    def __init__(self, iou_min: float = 0.3, ema_alpha: float = 0.6,
                 max_coast: int = 10, min_hits: int = 1):
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        if not 0.0 <= iou_min <= 1.0:
            raise ValueError(f"iou_min must be in [0, 1], got {iou_min}")
        self.iou_min = float(iou_min)
        self.ema_alpha = float(ema_alpha)
        self.max_coast = int(max_coast)
        self.min_hits = max(1, int(min_hits))
        self.tracks: Dict[int, Track] = {}
        self.next_id = 0
        self.born_total = 0
        self.died_total = 0

    # ------------------------------------------------------------------
    def update(self, frame_idx: int,
               detections: Sequence[Detection]) -> TrackerUpdate:
        tracks = list(self.tracks.values())
        used_tracks, used_dets = set(), set()
        matched: List[Track] = []
        if tracks and detections:
            # full IoU matrix in one numpy pass: float64
            # arithmetic in the exact order of the scalar iou(), so every
            # candidate value — and therefore every greedy assignment —
            # is bit-identical to the historical nested-loop version
            tb = np.asarray([t.box for t in tracks], np.float64)
            db = np.asarray([d[0] for d in detections], np.float64)
            ix1 = np.maximum(tb[:, None, 0], db[None, :, 0])
            iy1 = np.maximum(tb[:, None, 1], db[None, :, 1])
            ix2 = np.minimum(tb[:, None, 2], db[None, :, 2])
            iy2 = np.minimum(tb[:, None, 3], db[None, :, 3])
            inter = np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1)
            area_t = np.maximum(0.0, tb[:, 2] - tb[:, 0]) * \
                np.maximum(0.0, tb[:, 3] - tb[:, 1])
            area_d = np.maximum(0.0, db[:, 2] - db[:, 0]) * \
                np.maximum(0.0, db[:, 3] - db[:, 1])
            union = area_t[:, None] + area_d[None, :] - inter
            # inter > 0 implies union >= inter > 0 (each area bounds the
            # intersection), so the guarded divide mirrors iou()'s early
            # returns exactly
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.where(inter > 0.0, inter / union, 0.0)
            ti, dj = np.nonzero(v >= self.iou_min)
            if ti.size:
                tids = np.asarray([t.id for t in tracks], np.int64)[ti]
                # lexsort keys are LAST-is-primary: -iou descending, then
                # track id, then detection index — the tuple order
                # pairs.sort() used on (-iou, t.id, di)
                order = np.lexsort((dj, tids, -v[ti, dj]))
                a = self.ema_alpha
                for k in order:
                    tid, di = int(tids[k]), int(dj[k])
                    if tid in used_tracks or di in used_dets:
                        continue
                    used_tracks.add(tid)
                    used_dets.add(di)
                    t = self.tracks[tid]
                    box, score = detections[di]
                    t.box = tuple(a * float(d) + (1.0 - a) * p
                                  for d, p in zip(box, t.box))
                    t.score = float(score)
                    t.hits += 1
                    t.misses = 0
                    t.last_frame = int(frame_idx)
                    if t.hits >= self.min_hits:
                        matched.append(t)
        born: List[Track] = []
        confirmed_born: List[Track] = []
        for di, (box, score) in enumerate(detections):
            if di in used_dets:
                continue
            t = Track(self.next_id, box, score, frame_idx)
            self.next_id += 1
            self.tracks[t.id] = t
            self.born_total += 1
            born.append(t)
            if t.hits >= self.min_hits:
                confirmed_born.append(t)
        coasting: List[Track] = []
        died: List[Track] = []
        for t in tracks:
            if t.id in used_tracks:
                continue
            t.misses += 1
            if t.misses > self.max_coast:
                died.append(t)
                del self.tracks[t.id]
                self.died_total += 1
            else:
                coasting.append(t)
        return TrackerUpdate(matched, born, coasting, died,
                     confirmed_born)

    # ------------------------------------------------------------------
    def active(self) -> List[Track]:
        return sorted(self.tracks.values(), key=lambda t: t.id)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [t.snapshot() for t in self.active()]

    # ------------------------------------------------------------------
    # durability (streaming session snapshots)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"next_id": self.next_id, "born_total": self.born_total,
                "died_total": self.died_total,
                "tracks": [t.state_dict() for t in self.active()]}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.next_id = int(d["next_id"])
        self.born_total = int(d["born_total"])
        self.died_total = int(d["died_total"])
        self.tracks = {}
        for td in d["tracks"]:
            t = Track.from_state_dict(td)
            self.tracks[t.id] = t
