"""Per-step training telemetry: time breakdown, throughput, MFU, catalog.

The counterpart of ``deepfake_detection_tpu/obs/telemetry.py``, with its
registry, catalog, histogram bounds and event records, so a ``/metrics``
scraper and ``tools/obs_report.py`` read a port run as they read a JAX
one.  The tracker rides the trainer's existing metric drain and adds **no
device sync**: every input is a host float the trainer already holds (the
drain's ``float(m["loss"])`` reads) or a ``time.perf_counter`` delta around
work the loop already does.  A drain window's wall time splits three ways:

* **data wait**: the loop blocked on ``next(loader)`` (the host pipeline
  starving the card), the trainer's per-step data time;
* **device wait**: the loop blocked reading the buffered metric scalars
  back at the drain (the card still running its step backlog).  Those
  reads are the loop's only synchronizing calls, so this is the
  asynchronous-launch measure of "the card is the bottleneck";
* **host time**: the rest: launching the step's kernels, Python.

The ``DeviceLoader`` adds its own counters (``input_*``): the wait for the
host threads and the host seconds of the Prologue's enqueue (the device
augment chain); the tracker only reads them.

Throughput (images/s over the window) times the per-sample forward FLOPs
(:func:`forward_flops_per_sample`, × 3 for forward and backward, the usual
training approximation) over the card's dense bf16 peak
(:func:`peak_flops`) is the **live MFU gauge**.

The JAX module's ``native_warp_collector`` is left out: it reports the
native C warp of the JAX host chain, and the port's warp is the device
Prologue, which :func:`loader_collector` reports.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils.prometheus import LatencyHistogram, PromText

_logger = logging.getLogger(__name__)

__all__ = ["TrainTelemetry", "forward_flops_per_sample", "flops_buckets",
           "peak_flops", "loader_collector", "resilience_collector"]

_PREFIX = "dfd_train"

#: step/data-wait histogram bounds: 1 ms .. 60 s (first-step kernel builds
#: land in the top buckets; steady-state steps resolve at ms granularity)
_STEP_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: dense bf16 tensor-core peak per card, by a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheets: half the
#: with-sparsity rate), the JAX table's denominator rule
_PEAK_FLOPS = (
    ("H100 PCIe", 756.5e12),
    ("H100", 989.4e12),           # SXM: "NVIDIA H100 80GB HBM3"
    ("H200", 989.4e12),
)

_COUNTER_CATALOG = (
    ("steps_total", "Train steps dispatched"),
    ("samples_total", "Training samples consumed"),
    ("drains_total", "Metric drain boundaries (telemetry records)"),
    ("step_seconds_total", "Wall seconds spent in the train loop"),
    ("data_wait_seconds_total", "Seconds the loop blocked on next(loader)"),
    ("device_wait_seconds_total", "Seconds the drain blocked materializing "
     "buffered device scalars (device-bound time)"),
    ("nonfinite_steps_total", "Steps whose loss/grad-norm was non-finite"),
    ("guard_spike_steps_total", "Steps the anomaly guard flagged as loss "
     "spikes"),
    ("rewinds_total", "Guard rewinds to a recovery snapshot"),
    ("recovery_snapshots_total", "In-epoch recovery snapshots written"),
    ("preemptions_total", "Preemption stops honored at a step boundary"),
    ("profile_captures_total", "On-demand profiler trace windows captured"),
    ("watchdog_beats_total", "Stall-watchdog heartbeats received"),
    ("watchdog_near_misses_total", "Heartbeats older than 0.5x the "
     "watchdog timeout when they landed"),
    ("events_total", "Lifecycle events recorded to the JSONL log"),
)

_GAUGE_CATALOG = (
    ("up", "1 while the trainer's telemetry is live"),
    ("epoch", "Current epoch"),
    ("update", "Global update counter at the last drain"),
    ("loss", "Train loss, epoch-running average at the last drain (the "
     "trainer log line's avg — spikes show in nonfinite/spike counters)"),
    ("prec1", "Train top-1 precision, epoch-running average at the last "
     "drain"),
    ("learning_rate", "Current learning rate"),
    ("throughput_imgs_per_s", "Images/sec over the last drain window"),
    ("step_time_ms", "Mean step wall time over the last drain window"),
    ("data_wait_frac", "Fraction of the last window blocked on input"),
    ("device_wait_frac", "Fraction of the last window blocked on the "
     "device backlog"),
    ("host_frac", "Fraction of the last window in host-side dispatch"),
    ("mfu", "Live model FLOPs utilization (0 when peak rate unknown, "
     "e.g. CPU)"),
    ("model_fwd_gflops_per_sample", "Per-sample forward GFLOPs feeding "
     "the MFU gauge (tools/flops_breakdown.py)"),
    ("restart_count", "Restart-wrapper relaunches of this run "
     "(DFD_RESTART_COUNT)"),
    ("watchdog_beat_age_s", "Seconds since the last watchdog heartbeat"),
)


class TrainTelemetry:
    """One registry per training process.

    Hot-path contract: :meth:`on_step` and :meth:`on_drain` take host
    floats only and never touch a tensor: a telemetry-on run makes exactly
    the synchronizing calls a telemetry-off run makes.
    """

    def __init__(self, event_log: Optional[Any] = None,
                 flops_per_sample: float = 0.0,
                 peak_flops: float = 0.0,
                 meta: Optional[Dict[str, Any]] = None):
        self.event_log = event_log
        self.flops_per_sample = float(flops_per_sample)
        self.peak = float(peak_flops)
        self.meta = dict(meta or {})
        self.profiler = None          # optional obs.profiler.ProfilerCapture
        self._lock = threading.RLock()
        self._c: "OrderedDict[str, float]" = OrderedDict()
        self._g: "OrderedDict[str, float]" = OrderedDict()
        self._help: Dict[str, str] = {}
        for name, help_ in _COUNTER_CATALOG:
            self._c[name] = 0.0
            self._help[name] = help_
        for name, help_ in _GAUGE_CATALOG:
            self._g[name] = 0.0
            self._help[name] = help_
        self._g["up"] = 1.0
        self._g["model_fwd_gflops_per_sample"] = round(
            self.flops_per_sample / 1e9, 3)
        self._g["restart_count"] = float(
            os.environ.get("DFD_RESTART_COUNT", 0) or 0)
        self.h_step = LatencyHistogram(_STEP_BOUNDS)
        self.h_data_wait = LatencyHistogram(_STEP_BOUNDS)
        self._collectors: List[Callable[[], Dict[str, Dict[str, float]]]] = []
        # drain-window accumulators (single writer: the train loop).  The
        # window is the SUM of the per-step wall times, which already cover
        # the loop end to end (data wait and the drain's block included),
        # so the breakdown's fractions are consistent by construction
        self._win_steps = 0
        self._win_samples = 0
        self._win_wall = 0.0
        self._win_data_wait = 0.0

    # -- registry ------------------------------------------------------
    def inc(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0.0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._g[name] = value

    def register_collector(
            self, fn: Callable[[], Dict[str, Dict[str, float]]]) -> None:
        """``fn`` returns ``{"counters": {...}, "gauges": {...}}`` of
        monotonic totals / current values; called at every drain and
        render, so its names are in the catalog from registration on."""
        self._collectors.append(fn)
        self._run_collectors()

    def _run_collectors(self) -> None:
        for fn in self._collectors:
            try:
                out = fn()
            except Exception as e:          # noqa: BLE001 — never kill a run
                _logger.warning("telemetry collector failed: %r", e)
                continue
            with self._lock:
                for k, v in out.get("counters", {}).items():
                    self._c[k] = float(v)
                for k, v in out.get("gauges", {}).items():
                    self._g[k] = float(v)

    # -- hot-loop hooks ------------------------------------------------
    def on_step(self, n_samples: int, data_wait_s: float,
                step_wall_s: float) -> None:
        """Once per loop iteration; host floats only."""
        self._win_steps += 1
        self._win_wall += step_wall_s
        self._win_samples += int(n_samples)
        self._win_data_wait += data_wait_s
        self.h_step.observe(step_wall_s)
        self.h_data_wait.observe(data_wait_s)
        with self._lock:
            self._c["steps_total"] += 1
            self._c["samples_total"] += n_samples
            self._c["step_seconds_total"] += step_wall_s
            self._c["data_wait_seconds_total"] += data_wait_s

    def on_drain(self, *, epoch: int, batch_idx: int, num_updates: int,
                 loss: float, prec1: float, lr: float,
                 drain_wait_s: float, nonfinite_steps: int = 0) -> None:
        """Once per drain, AFTER the trainer read the buffered scalars back
        (``drain_wait_s`` is how long that took; ``nonfinite_steps`` is the
        window's count of bad steps)."""
        wall = max(self._win_wall, 1e-9)
        steps, samples = self._win_steps, self._win_samples
        if steps == 0:
            return
        data_wait = self._win_data_wait
        imgs_per_s = samples / wall
        mfu = 0.0
        if self.peak > 0 and self.flops_per_sample > 0:
            mfu = imgs_per_s * self.flops_per_sample * 3.0 / self.peak
        with self._lock:
            self._c["drains_total"] += 1
            self._c["device_wait_seconds_total"] += drain_wait_s
            self._c["nonfinite_steps_total"] += max(int(nonfinite_steps), 0)
            g = self._g
            g["epoch"] = float(epoch)
            g["update"] = float(num_updates)
            g["loss"] = float(loss)
            g["prec1"] = float(prec1)
            g["learning_rate"] = float(lr)
            g["throughput_imgs_per_s"] = round(imgs_per_s, 3)
            g["step_time_ms"] = round(wall / steps * 1e3, 3)
            g["data_wait_frac"] = round(min(data_wait / wall, 1.0), 4)
            g["device_wait_frac"] = round(min(drain_wait_s / wall, 1.0), 4)
            g["host_frac"] = round(
                max(1.0 - (data_wait + drain_wait_s) / wall, 0.0), 4)
            g["mfu"] = round(mfu, 4)
        self._run_collectors()
        if self.event_log is not None:
            with self._lock:
                counters = dict(self._c)
                gauges = {k: v for k, v in self._g.items()
                          if k not in ("up",)}
            self.event_log.metrics(
                epoch=epoch, batch=batch_idx, update=num_updates,
                imgs_per_s=round(imgs_per_s, 3),
                step_ms=gauges["step_time_ms"],
                data_wait_frac=gauges["data_wait_frac"],
                device_wait_frac=gauges["device_wait_frac"],
                host_frac=gauges["host_frac"],
                loss=float(loss), prec1=float(prec1), lr=float(lr),
                mfu=gauges["mfu"], counters=counters)
        self._win_steps = 0
        self._win_samples = 0
        self._win_wall = 0.0
        self._win_data_wait = 0.0

    # -- lifecycle -----------------------------------------------------
    def event(self, name: str, **fields: Any) -> None:
        self.inc("events_total")
        if name == "rewind":
            self.inc("rewinds_total")
        elif name == "preempted":
            self.inc("preemptions_total")
        elif name == "profile_capture":
            self.inc("profile_captures_total")
        if self.event_log is not None:
            self.event_log.event(name, **fields)

    def close(self) -> None:
        self.set_gauge("up", 0.0)
        if self.event_log is not None:
            self.event_log.close()

    # -- exposition ----------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """One consistent view of the whole registry."""
        self._run_collectors()
        with self._lock:
            return {"counters": dict(self._c), "gauges": dict(self._g)}

    def render_prometheus(self) -> str:
        snap = self.snapshot()
        doc = PromText(_PREFIX)
        for name, value in snap["counters"].items():
            doc.counter(name, self._help.get(name, name), _num(value))
        for name, value in snap["gauges"].items():
            doc.gauge(name, self._help.get(name, name), _num(value))
        doc.histogram("step_seconds", "Per-step wall time", self.h_step)
        doc.histogram("data_wait_seconds",
                      "Per-step input wait", self.h_data_wait)
        return doc.render()


def _num(v: float):
    """Integral values render without a trailing .0 (counter idiom)."""
    return int(v) if float(v).is_integer() else v


# ---------------------------------------------------------------------------
# MFU inputs
# ---------------------------------------------------------------------------

def peak_flops(device=None) -> float:
    """The card's dense bf16 peak, the MFU denominator; 0.0 on the CPU or
    an unknown card (the gauge then reads 0, not a meaningless ratio).
    ``device`` is a device name, a ``torch.device`` or None (the current
    CUDA device, if any)."""
    if device is None or not isinstance(device, str):
        import torch
        if device is not None and torch.device(device).type != "cuda":
            return 0.0
        if not torch.cuda.is_available():
            return 0.0
        device = torch.cuda.get_device_name(device)
    for key, rate in _PEAK_FLOPS:
        if key.lower() in device.lower():
            return rate
    return 0.0


def flops_buckets(model, input_shape: Sequence[int]) -> Dict[str, float]:
    """Per-sample forward FLOPs of ``model`` by ``tools/flops_breakdown.py``'s
    buckets (``conv_stem_mxu``, ``conv_dense_mxu``, ``conv_depthwise_vpu``,
    ``conv_grouped_partial``, ``dot_mxu``), 2 per multiply-add.

    The eval forward runs once on fake CPU tensors (``FakeTensorMode``:
    shapes only, no memory, no kernel launch; being CPU tensors, they take
    the kernels' plain versions) under a torch-function hook that sees
    every conv (dense, grouped and the depthwise plain version), linear,
    matmul and einsum call: the port's counterpart of the JAX tool's jaxpr
    walk over ``conv_general_dilated`` and ``dot_general``.
    ``input_shape`` is the NCHW ``(1, C, H, W)`` the model is fed."""
    import torch
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.overrides import TorchFunctionMode

    in_chans = int(input_shape[1])
    stem_chans = (in_chans, 4 * in_chans)       # raw or space-to-depth
    buckets: Dict[str, float] = {}
    stem_seen = [False]

    def add(key: str, flops: float) -> None:
        buckets[key] = buckets.get(key, 0.0) + flops

    def contracted(eq: str, operands) -> float:
        ins, out = eq.replace(" ", "").split("->")
        sizes = {}
        for spec, t in zip(ins.split(","), operands):
            sizes.update(zip(spec, t.shape))
        k = 1.0
        for letter in set(ins.replace(",", "")) - set(out):
            k *= sizes[letter]
        return k

    matmuls = {torch.matmul, torch.bmm, torch.Tensor.matmul,
               torch.Tensor.__matmul__, torch.Tensor.bmm}

    class _Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func in (F.conv2d, torch.conv2d):
                x, w = args[0], args[1]
                groups = args[6] if len(args) > 6 else kwargs.get("groups", 1)
                cin = x.shape[1]
                f = 2.0 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
                if groups == 1 and cin in stem_chans and not stem_seen[0]:
                    stem_seen[0] = True
                    add("conv_stem_mxu", f)
                elif groups == 1:
                    add("conv_dense_mxu", f)
                elif groups == cin:
                    add("conv_depthwise_vpu", f)
                else:
                    add("conv_grouped_partial", f)
            elif func is F.linear:
                add("dot_mxu", 2.0 * out.numel() * args[1].shape[1])
            elif func in matmuls:
                add("dot_mxu", 2.0 * out.numel() * args[0].shape[-1])
            elif func is torch.einsum:
                ops = args[1:] if len(args) > 2 or not isinstance(
                    args[1], (list, tuple)) else args[1]
                add("dot_mxu", 2.0 * out.numel() * contracted(args[0], ops))
            return out

    shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    dtype = next(iter(model.parameters())).dtype
    was_training = model.training
    model.eval()
    try:
        with FakeTensorMode(), torch.no_grad():
            state = {k: torch.empty(shape, dtype=dt, device="cpu")
                     for k, (shape, dt) in shapes.items()}
            x = torch.empty(tuple(input_shape), dtype=dtype, device="cpu")
            with _Count():
                torch.func.functional_call(model, state, (x,))
    finally:
        model.train(was_training)
    batch = int(input_shape[0])
    return {k: v / batch for k, v in buckets.items()}


def forward_flops_per_sample(model, input_shape: Sequence[int]) -> float:
    """Per-sample forward FLOPs (:func:`flops_buckets` summed), the MFU
    gauge's numerator; 0.0 when the count fails, so the gauge stays 0
    instead of lying."""
    try:
        return float(sum(flops_buckets(model, input_shape).values()))
    except Exception as e:              # noqa: BLE001 — telemetry is optional
        _logger.warning("forward-FLOPs count failed (%r); MFU gauge "
                        "disabled", e)
        return 0.0


# ---------------------------------------------------------------------------
# Collectors: input pipeline, resilience
# ---------------------------------------------------------------------------

def loader_collector(device_loader, name: str = "train"):
    """Input-pipeline counters/gauges off a ``data.loader.DeviceLoader`` and
    its host loader (on the shm transport also its worker respawns, stall
    sweeps, collect wait, live workers and ring occupancy): attribute reads
    only, no locking against the producer (single-writer floats, no torn
    reads under the GIL)."""

    def collect() -> Dict[str, Dict[str, float]]:
        st = device_loader.stats
        host = device_loader.loader
        c = {
            f"input_{name}_batches_total": st.batches,
            f"input_{name}_host_wait_seconds_total": st.host_wait_s,
            # the host seconds of the Prologue's enqueue: the copy to the
            # card and the device augment chain's launches, with any wait
            # they make on the device
            f"input_{name}_stage_block_seconds_total": st.stage_s,
            # samples x host-chain stages (warp/blur/mixup-blend) the
            # device Prologue ran in their place
            f"input_{name}_host_augment_stages_elided_total":
                st.augment_elided,
            f"input_{name}_fetch_seconds_total": host.stats.fetch_s,
        }
        g = {f"input_{name}_augment_path_device":
             1.0 if device_loader.prologue.spec is not None else 0.0}
        if hasattr(host, "ring_depth"):  # the shm transport
            c[f"input_{name}_worker_respawns_total"] = host.respawn_count
            c[f"input_{name}_ring_stall_sweeps_total"] = host.stall_sweeps
            c[f"input_{name}_ring_collect_wait_seconds_total"] = \
                host.collect_wait_s
            workers = [p for p in host._workers if p is not None]
            g[f"input_{name}_workers_alive"] = float(
                sum(1 for p in workers if p.is_alive()))
            g[f"input_{name}_ring_occupancy"] = round(
                min(host.inflight_batches / float(host.ring_depth), 1.0), 4)
        return {"counters": c, "gauges": g}

    return collect


def resilience_collector(resilience):
    """Fault-layer counters off a ``train.resilience.Resilience``."""

    def collect() -> Dict[str, Dict[str, float]]:
        c: Dict[str, float] = {}
        g: Dict[str, float] = {}
        guard = resilience.guard
        if guard is not None:
            c["guard_spike_steps_total"] = guard.spike_total
        wd = resilience.watchdog
        if wd is not None:
            c["watchdog_beats_total"] = wd.beats_total
            c["watchdog_near_misses_total"] = wd.near_miss_total
            g["watchdog_beat_age_s"] = round(wd.beat_age(), 3)
        return {"counters": c, "gauges": g}

    return collect
