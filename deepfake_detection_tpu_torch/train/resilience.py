"""Training resilience layer: preemption-safe stop, NaN/spike guard, stall
watchdog.

Counterpart of ``deepfake_detection_tpu/train/resilience.py``, the same
classes and exit codes, for the port's one process on one card.

The reference stack dies wholesale on any fault: an ``mp.spawn`` worker
fault kills the job, a preempted host restarts from the last *epoch*
boundary, a NaN step silently poisons the params, and a hung collective
hangs forever.  This module gives the runner four coordinated defenses:

* :class:`PreemptionHandler` — SIGTERM/SIGINT request a stop at the next
  step boundary; the trainer then writes a *synchronous* recovery snapshot
  carrying the exact loop position and the run exits :data:`EXIT_PREEMPTED`
  so a restart wrapper (scripts/train.sh) can relaunch into
  ``--auto-resume``.  A second signal falls through to the original
  handler (an impatient operator can still hard-kill).
* :class:`AnomalyGuard` — host-side policy fed at the trainer's existing
  metric-drain cadence (no extra device syncs): counts non-finite steps,
  flags loss spikes against rolling robust statistics (median/MAD), and
  after K *consecutive* bad steps raises :class:`RewindRequested` so the
  runner restores the last recovery snapshot instead of continuing on
  corrupted state.  The device-side skip (train/steps.py ``nonfinite_guard``)
  keeps params finite in the meantime.
* :class:`StallWatchdog` — a monitor thread fed by step-completion
  heartbeats (the shm ring's worker-heartbeat idiom, one level up).  On
  timeout it dumps every Python thread's stack plus the loop position and
  aborts with :data:`EXIT_WATCHDOG` — turning a silent multi-hour hang
  (stuck collective, wedged loader) into a restartable event.
* :class:`Resilience` — the facade the runner owns: installs/restores the
  signal handlers (context manager, so in-process library use — tests —
  leaves no global state behind), carries the chaos injector, the rewind
  budget, and the watchdog.

Verdicts across processes: each process gets its own SIGTERM, at its own
step boundary, so a multi-process run must agree on the stop before it
acts.  :func:`allreduce_flags` and :meth:`Resilience.sync_verdicts` are that
agreement's seam: on one process (the port's only layout so far) they are
the identity, and multi-GPU (ROADMAP Queue 1 item 9) puts a
``torch.distributed`` store under them, with the guard's deferred rewind.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..chaos import ChaosInjector, chaos_from_env

_logger = logging.getLogger(__name__)

__all__ = ["EXIT_PREEMPTED", "EXIT_WATCHDOG", "Preempted", "RewindRequested",
           "PreemptionHandler", "AnomalyGuard", "StallWatchdog", "Resilience",
           "allreduce_flags"]

#: exit code after a signal-requested stop with a recovery snapshot on disk
#: (os.EX_TEMPFAIL: "try again later" — the restart wrapper relaunches)
EXIT_PREEMPTED = 75
#: exit code of a stall-watchdog abort (distinct from EXIT_PREEMPTED so the
#: wrapper can count the two failure classes separately if it wants to)
EXIT_WATCHDOG = 85


class Preempted(Exception):
    """Raised by the trainer at a step boundary after a stop request; the
    recovery snapshot is already on disk when this propagates."""

    def __init__(self, epoch: int, batch_idx: int, signum: int):
        super().__init__(
            f"preempted by signal {signum} at epoch {epoch} "
            f"batch {batch_idx}; recovery snapshot written")
        self.epoch = epoch
        self.batch_idx = batch_idx
        self.signum = signum


class RewindRequested(Exception):
    """Raised by the guard when training should rewind to the last
    recovery snapshot instead of continuing on suspect state."""


def allreduce_flags(flags: np.ndarray) -> np.ndarray:
    """Max-reduce a small int32 flag vector across processes: any process's
    1 becomes every process's 1.

    The port runs one process, so this returns the flags unchanged.  The
    trainer calls it at every step boundary, a pure function of the loop
    indices every process walks alike, which is what a store-backed
    reduction (ROADMAP Queue 1 item 9) needs of its callers.
    """
    return np.asarray(flags, np.int32)


class PreemptionHandler:
    """First SIGTERM/SIGINT sets a flag checked at step boundaries; a
    second delivery restores the original disposition and re-raises, so a
    stuck run can still be killed the ordinary way."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self.stop_requested = False
        self.signum: Optional[int] = None

    def install(self) -> bool:
        """Install handlers; False when not possible (non-main thread)."""
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
        except ValueError:          # signal only works in the main thread
            self.uninstall()
            return False
        return True

    def uninstall(self) -> None:
        for s, prev in list(self._previous.items()):
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        if self.stop_requested:
            # second signal: hand control back to the original handler
            # (default SIGTERM kills; SIGINT raises KeyboardInterrupt)
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.stop_requested = True
        self.signum = signum
        _logger.warning(
            "signal %d received: stopping at the next step boundary "
            "(second signal force-kills)", signum)


class AnomalyGuard:
    """Host-side anomaly policy over per-step loss scalars.

    Fed from the trainer's metric drain (the only place the host reads
    device scalars anyway).  Three signals combine into one "bad step"
    verdict:

    * the device-side non-finite flag (loss or global grad-norm),
    * a non-finite loss read on host (covers guard-off steps), and
    * a loss spike: ``|loss - median| > zmax * 1.4826 * MAD`` over the last
      ``spike_window`` *accepted* losses (robust statistics — a previous
      spike does not drag the baseline; MAD is floored so a flat early
      window cannot divide by ~0).

    ``rewind_after`` consecutive bad steps raise :class:`RewindRequested`.
    Isolated bad steps only count (the device-side skip already protected
    the params); the streak resets on any good step and on rewind.
    """

    def __init__(self, spike_window: int = 0, spike_zmax: float = 8.0,
                 rewind_after: int = 3):
        self.spike_window = int(spike_window)
        self.spike_zmax = float(spike_zmax)
        self.rewind_after = max(1, int(rewind_after))
        self._hist: deque = deque(maxlen=max(self.spike_window, 1))
        self.bad_streak = 0
        self.nonfinite_total = 0
        self.spike_total = 0

    def is_spike(self, loss: float) -> bool:
        if self.spike_window <= 0 or len(self._hist) < self.spike_window:
            return False
        med = float(np.median(self._hist))
        mad = float(np.median(np.abs(np.asarray(self._hist) - med)))
        scale = max(1.4826 * mad, 1e-3 * max(abs(med), 1.0))
        return abs(loss - med) > self.spike_zmax * scale

    def observe(self, step_index: int, loss: float,
                nonfinite: bool) -> bool:
        """Record one step; returns True when the step was bad.  Raises
        :class:`RewindRequested` on the ``rewind_after``-th consecutive
        bad step."""
        bad = bool(nonfinite) or not np.isfinite(loss)
        if bad:
            self.nonfinite_total += 1
        elif self.is_spike(loss):
            bad = True
            self.spike_total += 1
            _logger.warning(
                "loss spike at update %d: %.5f vs rolling median %.5f",
                step_index, loss, float(np.median(self._hist)))
        else:
            self._hist.append(float(loss))
        if not bad:
            self.bad_streak = 0
            return False
        self.bad_streak += 1
        if self.bad_streak >= self.rewind_after:
            raise RewindRequested(
                f"{self.bad_streak} consecutive bad steps "
                f"(last at update {step_index}, loss {loss!r})")
        return True

    def reset_streak(self) -> None:
        self.bad_streak = 0


class StallWatchdog:
    """Monitor thread fed by step-completion heartbeats.

    ``timeout`` seconds without a :meth:`beat` → dump all Python thread
    stacks + the loop position to stderr and abort the process with
    :data:`EXIT_WATCHDOG`.  ``os._exit`` semantics (via the injectable
    ``exit_fn``) are deliberate: a wedged collective or a deadlocked
    loader thread would block any graceful teardown path.

    The window before the FIRST beat is ``first_grace`` × longer: the
    first train step builds the kernels and warms the card's libraries
    (``nvcc``, lazy module loads) with no chance to heartbeat, and a
    watchdog sized to steady-state step time would otherwise abort during
    that warm-up on every relaunch — a restart loop that never completes
    a step.  Size ``timeout`` itself to cover
    the post-warmup stragglers (a first *eval* compile, a slow epoch
    boundary) — a few multiples of step time is too tight.

    ``dump_path``: the all-thread stack dump also lands in this file
    (``<outdir>/watchdog_dump.txt``) — stderr is routinely lost when the
    restart wrapper relaunches, and a post-mortem needs the stacks.
    ``beats_total`` counts the beats.  (The JAX class's telemetry gauges,
    ``near_miss_total`` and ``beat_age``, wait for the port's telemetry,
    ROADMAP Queue 1 item 8.)
    """

    def __init__(self, timeout: float,
                 position_fn: Optional[Callable[[], str]] = None,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 first_grace: float = 10.0,
                 dump_path: Optional[str] = None):
        self.timeout = float(timeout)
        self.first_grace = max(1.0, float(first_grace))
        self._position_fn = position_fn or (lambda: "<unknown>")
        self._exit_fn = exit_fn
        self.dump_path = dump_path
        self._last = time.monotonic()
        self._seen_beat = False
        self.beats_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()
        self._seen_beat = True
        self.beats_total += 1

    def start(self) -> None:
        if self.timeout <= 0 or self._thread is not None:
            return
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dfd-stall-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        poll = max(0.05, min(self.timeout / 4.0, 5.0))
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            limit = self.timeout if self._seen_beat \
                else self.timeout * self.first_grace
            if idle <= limit:
                continue
            self._fire(idle)
            return

    def _fire(self, idle: float) -> None:
        msg = (f"stall watchdog: no step completed for {idle:.1f}s "
               f"(timeout {self.timeout:.1f}s) at {self._position_fn()}; "
               f"dumping thread stacks and aborting with exit code "
               f"{EXIT_WATCHDOG}")
        _logger.critical(msg)
        try:
            print(msg, file=sys.stderr, flush=True)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
        except Exception:  # noqa: BLE001 — the abort must still happen
            pass
        if self.dump_path:
            # stderr is routinely lost when the restart wrapper relaunches
            # — persist the same dump where --auto-resume will find it
            try:
                with open(self.dump_path, "w") as f:
                    f.write(msg + "\n")
                    faulthandler.dump_traceback(file=f, all_threads=True)
            except Exception:  # noqa: BLE001 — the abort must still happen
                pass
        if self._exit_fn is not None:
            self._exit_fn(EXIT_WATCHDOG)
        else:
            os._exit(EXIT_WATCHDOG)


class Resilience:
    """Everything the runner threads through the hot loop, in one handle.

    Built by :meth:`from_config`; used as a context manager so signal
    handlers are always restored (the runner is also called in-process by
    tests and by programmatic users).
    """

    def __init__(self, preemption: Optional[PreemptionHandler] = None,
                 guard: Optional[AnomalyGuard] = None,
                 watchdog: Optional[StallWatchdog] = None,
                 chaos: Optional[ChaosInjector] = None,
                 rewind_limit: int = 2):
        self.preemption = preemption
        self.guard = guard
        self.watchdog = watchdog
        self.chaos = chaos if chaos is not None else ChaosInjector("")
        self.rewinds_left = max(0, int(rewind_limit))
        self.position = "<not started>"

    @classmethod
    def from_config(cls, cfg, output_dir: str = "") -> "Resilience":
        guard = None
        if cfg.guard_nonfinite != "off" or cfg.guard_spike_window > 0:
            guard = AnomalyGuard(spike_window=cfg.guard_spike_window,
                                 spike_zmax=cfg.guard_spike_zmax,
                                 rewind_after=cfg.guard_rewind_after)
        self = cls(preemption=PreemptionHandler(), guard=guard,
                   chaos=chaos_from_env(),
                   rewind_limit=cfg.guard_rewind_limit)
        if cfg.watchdog_timeout > 0:
            dump = os.path.join(output_dir, "watchdog_dump.txt") \
                if output_dir else None
            self.watchdog = StallWatchdog(
                cfg.watchdog_timeout, position_fn=lambda: self.position,
                dump_path=dump)
        return self

    # -- lifecycle -----------------------------------------------------
    def __enter__(self) -> "Resilience":
        if self.preemption is not None and not self.preemption.install():
            _logger.warning("not in the main thread: preemption signal "
                            "handlers not installed")
            self.preemption = None
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def __exit__(self, *exc) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.preemption is not None:
            self.preemption.uninstall()

    # -- hot-loop hooks (all cheap; trainer calls them per step) -------
    @property
    def stop_requested(self) -> bool:
        return self.preemption is not None and self.preemption.stop_requested

    @property
    def stop_signum(self) -> int:
        return self.preemption.signum if self.preemption is not None \
            and self.preemption.signum is not None else signal.SIGTERM

    def heartbeat(self, position: Optional[str] = None) -> None:
        if position is not None:
            self.position = position
        if self.watchdog is not None:
            self.watchdog.beat()

    def note(self, position: str) -> None:
        """Update the reported loop position WITHOUT feeding the watchdog
        a beat — for markers that precede the first completed step (epoch
        start), where a beat would end the watchdog's first-compile grace
        window before the compile it exists to protect."""
        self.position = position

    def observe_step(self, step_index: int, loss: float,
                     nonfinite: bool) -> bool:
        """Guard hook; returns True for a bad step, may raise
        :class:`RewindRequested`."""
        if self.guard is None:
            return bool(nonfinite) or not np.isfinite(loss)
        return self.guard.observe(step_index, loss, nonfinite)

    def sync_verdicts(self) -> bool:
        """The stop verdict agreed across processes: this process's
        preemption flag through :func:`allreduce_flags`, the identity on
        one process.  Call it at a boundary every process reaches."""
        return bool(allreduce_flags(np.array([self.stop_requested]))[0])

    def start_rewind(self, reason: str) -> None:
        """Account one rewind; raises when the budget is exhausted."""
        if self.rewinds_left <= 0:
            raise RuntimeError(
                f"rewind budget exhausted ({reason}); aborting rather "
                "than looping on corrupted state")
        self.rewinds_left -= 1
        if self.guard is not None:
            self.guard.reset_streak()
        _logger.warning("rewinding to the last recovery snapshot (%s); "
                        "%d rewind(s) left", reason, self.rewinds_left)
