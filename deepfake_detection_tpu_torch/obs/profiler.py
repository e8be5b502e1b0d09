"""On-demand profiler capture for a running training job.

The counterpart of ``deepfake_detection_tpu/obs/profiler.py`` on
``torch.profiler`` (CPU and CUDA activities): "where did this step's
milliseconds go" asked mid-run, of a job nobody wants to restart.  Two
triggers start a bounded trace window on a LIVE run:

* ``SIGUSR2``: ``kill -USR2 <pid>``;
* ``touch <output_dir>/PROFILE``, checked at the trainer's drain cadence
  (one ``stat`` a drain, nothing a step).

The trigger file is consumed, so one touch gives one capture, and each
capture lands in its own ``profile/ondemand-<update>/`` directory:
``trace.json`` (a Chrome trace) and ``kernels.json`` (each device
kernel's launches and microseconds over the window, and the window's
steps).  The window opens with one warm-up step whose events are dropped
(``torch.profiler.schedule``'s warmup: the device tracer can miss the
first kernels after it starts), so it spans ``num_steps`` + 1 steps and
records ``num_steps``.  The port trains on one card in one process, so
there is no rank to gate.

The signal handler only sets a plain attribute: it takes no lock, logs
nothing and sets no ``threading.Event`` (a handler that does can deadlock
the main thread it interrupts, when that thread holds the same lock).
Idle, the cost is two attribute checks a step and one ``stat`` a drain;
a window's start and stop add one device synchronize at its stop, so the
trace covers the device work of its steps.
"""

from __future__ import annotations

import json
import logging
import os
import signal

_logger = logging.getLogger(__name__)

__all__ = ["ProfilerCapture", "TRIGGER_FILENAME"]

TRIGGER_FILENAME = "PROFILE"


class ProfilerCapture:
    """Bounded on-demand trace windows over a running train loop.

    The trainer calls :meth:`poll` at its drain cadence (the file trigger)
    and :meth:`on_step` once a step (the window's start and stop).
    ``telemetry`` (an optional TrainTelemetry) gets a ``profile_capture``
    event a completed window.
    """

    def __init__(self, output_dir: str, num_steps: int = 20,
                 telemetry=None, signum: int = signal.SIGUSR2):
        self.output_dir = output_dir
        self.num_steps = max(1, int(num_steps))
        self.telemetry = telemetry
        self._signum = signum
        self._prev_handler = None
        self._installed = False
        # written by the signal handler and poll(), read a step
        self._want = False
        self.active = False
        self._stop_after = -1
        self._trace_dir = ""
        self._prof = None
        self.captures_total = 0

    # -- triggers ------------------------------------------------------
    def install(self) -> bool:
        """Install the SIGUSR2 handler; False outside the main thread (the
        file trigger still works)."""
        try:
            self._prev_handler = signal.signal(self._signum, self._handle)
        except ValueError:
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        if self._installed:
            try:
                signal.signal(self._signum, self._prev_handler
                              or signal.SIG_DFL)
            except (ValueError, TypeError):
                pass
            self._installed = False

    def _handle(self, signum, frame) -> None:
        self._want = True

    @property
    def _trigger_path(self) -> str:
        return os.path.join(self.output_dir, TRIGGER_FILENAME)

    def poll(self) -> None:
        """Drain-cadence check of the file trigger (one stat)."""
        if self._want or self.active or not self.output_dir:
            return
        if os.path.exists(self._trigger_path):
            self._want = True

    # -- window management --------------------------------------------
    def on_step(self, step_index: int, sync_ref=None) -> None:
        """Once a train step, after its launch.

        Starts a requested window (a warm-up step, then ``num_steps``
        recorded steps), steps an active one, or stops it once they were
        all launched (``sync_ref``, the latest step's loss, names the device
        to synchronize first, so the trace holds their device work)."""
        if self.active:
            if step_index >= self._stop_after:
                self.stop(sync_ref)
            else:
                self._prof.step()
        if not self._want or self.active:
            return
        self._want = False
        self._consume_trigger()
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        self._trace_dir = os.path.join(self.output_dir, "profile",
                                       f"ondemand-{step_index}")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            self._prof = profile(
                activities=activities, on_trace_ready=self._write,
                schedule=schedule(wait=0, warmup=1, active=self.num_steps,
                                  repeat=1))
            self._prof.start()
        except Exception as e:          # noqa: BLE001 — never kill the run
            _logger.warning("profiler capture failed to start: %r", e)
            self._prof = None
            return
        self.active = True
        self._stop_after = step_index + 1 + self.num_steps
        _logger.warning("profiler capture started at update %d -> %s (%d "
                        "steps)", step_index, self._trace_dir,
                        self.num_steps)

    def _write(self, prof) -> None:
        """The schedule's trace-ready hook: the trace and its kernels."""
        import torch

        os.makedirs(self._trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self._trace_dir, "trace.json"))
        kernels = {
            e.key: {"launches": e.count, "device_us": e.self_device_time_total}
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}
        with open(os.path.join(self._trace_dir, "kernels.json"), "w") as f:
            json.dump({"steps": prof.step_num, "kernels": kernels}, f,
                      indent=1, sort_keys=True)

    def stop(self, sync_ref=None) -> None:
        if not self.active:
            return
        import torch

        self.active = False
        try:
            if sync_ref is not None and sync_ref.device.type == "cuda":
                torch.cuda.synchronize(sync_ref.device)
            self._prof.stop()           # the recorded steps' trace is ready
        except Exception as e:          # noqa: BLE001
            _logger.warning("profiler capture failed to stop cleanly: %r", e)
        self._prof = None
        self.captures_total += 1
        _logger.warning("profiler capture written to %s", self._trace_dir)
        if self.telemetry is not None:
            self.telemetry.event("profile_capture", trace_dir=self._trace_dir,
                                 num_steps=self.num_steps)

    def _consume_trigger(self) -> None:
        try:
            os.unlink(self._trigger_path)
        except OSError:
            pass

    def close(self) -> None:
        self.stop()
        self.uninstall()
