"""Per-stream score aggregation: EMA + hysteresis verdict state machine.

Counterpart of ``deepfake_detection_tpu/streaming/verdict.py``, byte for
byte in its thresholds, severities and event schema.

A live stream produces a noisy sequence of per-window fake scores; the
product question is a *stable* per-stream answer ("is this feed fake?")
that neither flaps on score noise nor lags a real manipulation.  The
classic control answer is used here:

* an **EMA** over window scores absorbs single-window noise (one bad crop
  or a shed window cannot flip the verdict);
* **hysteresis** thresholds make every state change sticky — each state is
  *entered* at a higher score than it is *exited* (``suspect_enter`` >
  ``suspect_exit``, ``fake_enter`` > ``fake_exit``), so an EMA wandering
  inside the gap cannot oscillate between two verdicts
  (tests/test_streaming.py pins the no-flap property).

States escalate ``real → suspect → fake`` and de-escalate one level at a
time; a single large EMA jump may emit several transition events in one
update (each level crossed is witnessed by its own event, so downstream
consumers always see a connected path through the state graph).

Every transition is emitted as a **schema-versioned** event dict
(:data:`EVENT_SCHEMA`) so the wire format can evolve without breaking
consumers — the JSONL event-log discipline of ``obs/events.py`` applied
to the streaming subsystem.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

__all__ = ["REAL", "SUSPECT", "FAKE", "SEVERITY", "EVENT_SCHEMA",
           "VerdictThresholds", "VerdictMachine"]

REAL = "real"
SUSPECT = "suspect"
FAKE = "fake"

#: escalation order; higher = worse (stream verdict = max over tracks)
SEVERITY = {REAL: 0, SUSPECT: 1, FAKE: 2}

#: bump on any backwards-incompatible change to the event dict layout
EVENT_SCHEMA = "dfd.streaming.verdict.v1"


class VerdictThresholds:
    """Validated hysteresis threshold set (shared by every machine of a
    server, so validation happens once at config time)."""

    __slots__ = ("suspect_enter", "suspect_exit", "fake_enter", "fake_exit")

    def __init__(self, suspect_enter: float = 0.5, suspect_exit: float = 0.35,
                 fake_enter: float = 0.8, fake_exit: float = 0.65):
        self.suspect_enter = float(suspect_enter)
        self.suspect_exit = float(suspect_exit)
        self.fake_enter = float(fake_enter)
        self.fake_exit = float(fake_exit)
        if not (0.0 <= self.suspect_exit < self.suspect_enter <= 1.0):
            raise ValueError(
                f"need 0 <= suspect_exit < suspect_enter <= 1, got "
                f"exit={self.suspect_exit} enter={self.suspect_enter}")
        if not (0.0 <= self.fake_exit < self.fake_enter <= 1.0):
            raise ValueError(
                f"need 0 <= fake_exit < fake_enter <= 1, got "
                f"exit={self.fake_exit} enter={self.fake_enter}")
        if self.suspect_enter > self.fake_enter:
            raise ValueError(
                f"suspect_enter ({self.suspect_enter}) must not exceed "
                f"fake_enter ({self.fake_enter})")
        if self.suspect_exit > self.fake_exit:
            raise ValueError(
                f"suspect_exit ({self.suspect_exit}) must not exceed "
                f"fake_exit ({self.fake_exit})")

    def to_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in self.__slots__}


class VerdictMachine:
    """One EMA + hysteresis state machine (per track, and one per stream).

    ``update()`` folds a window's fake score into the EMA and returns the
    (possibly empty) list of transition events it caused.  Deterministic:
    state depends only on the score sequence, never on wall time (the
    ``wall_time`` stamped into events is advisory metadata).
    """

    def __init__(self, thresholds: Optional[VerdictThresholds] = None,
                 ema_alpha: float = 0.3, min_windows: int = 1,
                 context: Optional[Dict[str, Any]] = None):
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        if min_windows < 1:
            raise ValueError(f"min_windows must be >= 1, got {min_windows}")
        self.thresholds = thresholds or VerdictThresholds()
        self.ema_alpha = float(ema_alpha)
        self.min_windows = int(min_windows)
        self.context = dict(context or {})
        self.state = REAL
        self.ema: Optional[float] = None
        self.windows = 0
        self.transitions = 0
        self.last_score: Optional[float] = None

    # ------------------------------------------------------------------
    def _next_state(self) -> str:
        """One hysteresis step from the current (state, ema)."""
        t, e = self.thresholds, self.ema
        if self.state == REAL:
            return SUSPECT if e >= t.suspect_enter else REAL
        if self.state == SUSPECT:
            if e >= t.fake_enter:
                return FAKE
            if e < t.suspect_exit:
                return REAL
            return SUSPECT
        # FAKE
        return SUSPECT if e < t.fake_exit else FAKE

    def update(self, score: float, *, frame_idx: Optional[int] = None,
               wall_time: Optional[float] = None) -> List[Dict[str, Any]]:
        """Fold one window score in; returns transition events (often [])."""
        score = float(score)
        self.last_score = score
        self.ema = score if self.ema is None else \
            self.ema_alpha * score + (1.0 - self.ema_alpha) * self.ema
        self.windows += 1
        if self.windows < self.min_windows:
            return []                  # EMA warms up before verdicts move
        events: List[Dict[str, Any]] = []
        # walk one level at a time so a big EMA jump still emits a
        # connected real→suspect→fake path (two events, not one leap)
        while True:
            nxt = self._next_state()
            if nxt == self.state:
                break
            event = {
                "schema": EVENT_SCHEMA,
                "event": "verdict",
                "from": self.state,
                "to": nxt,
                "ema": round(self.ema, 6),
                "score": round(score, 6),
                "windows": self.windows,
                "wall_time": time.time() if wall_time is None else wall_time,
            }
            if frame_idx is not None:
                event["frame_idx"] = int(frame_idx)
            event.update(self.context)
            events.append(event)
            self.state = nxt
            self.transitions += 1
        return events

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "ema": None if self.ema is None else round(self.ema, 6),
            "windows": self.windows,
            "transitions": self.transitions,
            "last_score": self.last_score,
        }

    # ------------------------------------------------------------------
    # durability (streaming session snapshots): unlike snapshot(), the
    # state dict is FULL precision — a restored machine must continue the
    # score sequence bit-identically to one that never stopped
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "ema": self.ema,               # unrounded: EMA continuity
            "windows": self.windows,
            "transitions": self.transitions,
            "last_score": self.last_score,
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if d["state"] not in SEVERITY:
            raise ValueError(f"unknown verdict state {d['state']!r}")
        self.state = d["state"]
        self.ema = None if d["ema"] is None else float(d["ema"])
        self.windows = int(d["windows"])
        self.transitions = int(d["transitions"])
        self.last_score = None if d.get("last_score") is None else \
            float(d["last_score"])
