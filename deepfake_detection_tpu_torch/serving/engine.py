"""Inference engine: a multi-model table over one program per (model,
bucket, channel width), double-buffered staging, hot weight reload.

The counterpart of ``deepfake_detection_tpu/serving/engine.py``, with its
structure and names; where the JAX engine AOT-compiles an XLA executable,
this one captures a CUDA graph.

* **Model table** — N models behind ONE worker loop and ONE micro-batch
  queue: each :class:`_ModelEntry` owns its module, its canvas geometry,
  its programs and its reload/canary state.  Programs are keyed ``(bucket,
  chans)`` per entry, made before the server reports ready; a model added
  to a warmed engine DROPS readiness until its own warmup ran.

* **Programs** — on the card one ``torch.cuda.CUDAGraph`` per (model,
  bucket, chans), captured at warmup over a static input buffer (uint8
  NHWC on the uint8 wire, float32 on the float32 wire), the uint8 wire's
  normalize and ×img_num replication (the JAX ``_score``'s elementwise
  float32 arithmetic), the model's eval forward and the softmax, into a
  static output.  A partial batch pads to the nearest bucket and the pad
  rows are sliced off; an unknown bucket or channel width is a hard
  error.  Nothing is captured after ready: ``compiles_total`` counts the
  programs readied, and the process-wide capture count
  (``backend_compiles_total``) growing after ready is the alarm.  On the
  CPU (``device='cpu'``, the tests) the same programs run eagerly, which
  is the only difference; on the card a capture that fails raises out of
  :meth:`warmup`, with no eager fallback.

* **Capture discipline** — a program's first run does work a capture may
  not contain (the depthwise kernels' build and ``dlopen``, the SM count,
  the lookup of the TMA encoder ``cuTensorMapEncodeTiled``,
  ``cudaFuncSetAttribute``, cuDNN's algorithm choice), so each program
  runs once eagerly on a side stream before it is captured.  Every capture of an engine shares one
  graph memory pool: the replays are serialized on one serving stream, so
  no two graphs' intermediates are live at once.  Captures use
  ``capture_error_mode="thread_local"`` AND hold the engine's device lock,
  which every sequence of device work the engine enqueues (copy in, replay,
  copy out, event) also holds: a live :meth:`add_model` captures on its
  caller's thread while the worker keeps serving, and never between a
  replay and its copies.

* **Addresses are baked in** — a graph keeps every address it was
  captured with (the depthwise kernels encode the input's address into a
  TMA tensor map at launch), so inputs are copied into the static buffer,
  never rebound, and a hot reload ``copy_``s the candidate's tensors into
  the live parameters and buffers in place, between batches, on the
  serving stream.

* **Double-buffered staging** — while batch k executes, the engine drains
  already-queued requests into batch k+1 and dispatches it before
  blocking on k's result.  Batch k+1's replay overwrites the static
  output, so each replay's output is copied right after it, on the same
  stream, into a pinned host slot of its own, and an event is recorded:
  the JAX ``is_ready`` becomes ``event.query()``.  The host refills a
  slot's pinned input only after the event of the copy that read it.

* **Post-training quantization** (serving/quant.py) — ``dtype`` bf16
  casts a model's parameters, ``int8`` quantizes its conv and linear
  kernels per output channel.  The entry keeps the quantized tensors (int8
  values plus f32 scales, or bf16) as its resident *store*, and its module
  keeps no f32 copy of them (their parameters become shape-only ``meta``
  tensors); the program realizes the store (``quant.realize``) and runs
  the module on the realized weights through ``torch.func.
  functional_call``, all inside the captured graph, the counterpart of the
  JAX ``realize_tree`` inside the jitted call.  The realized f32 weights
  are temporaries of the graph's pool, at fixed addresses.  At f32 there
  is no store and the program is the module itself.

* **Hot weight reload** — a watcher thread per watched model polls a
  checkpoint dir; a new torch file is loaded on the host, gated by shape,
  quantized to the entry's dtype, scored by a golden-batch canary on a
  separate *candidate* module and store (never the live tensors), and
  committed between batches by ``copy_`` into the live tensors and the
  resident store.  A rejected reload leaves the live tensors, and so the
  scores, bitwise unchanged.

* **Warm start** (``warmstart=``, serving/warmstart.py) — a CUDA graph
  cannot be serialized, so a store holds what carries across processes:
  the kernel libraries (``csrc/build.py`` consults the store before nvcc
  and canaries what it loads) and one capture manifest per (model program,
  bucket, chans, wire, quant) with the golden-batch scores and the params
  fingerprint at save time.  Every unit is captured; on a manifest hit the
  golden-batch canary (:meth:`_warm_canary`) replays the capture: bitwise
  the manifest's scores under the same fingerprint, else finite and of the
  right shape (and the manifest is re-stamped).  On a miss or a fallback
  the manifest is saved after the capture.  A canary reject rebuilds the
  libraries that came from the store by nvcc (under new file names: a
  graph holds its library's function addresses, and no library is ever
  unloaded) and captures every unit of every entry again.  The store's and
  the libraries' counts land in the ``warmstart_*`` counters.

* **Self-healing** (serving/resilience.py) — the JAX engine's contracts,
  each counted in /metrics and reachable through ``DFD_CHAOS``
  (``serve_exc`` / ``serve_nan`` / ``serve_hang`` / ``serve_kill`` /
  ``torn_reload``): non-finite batches fail 503; a stuck batch or a dead
  worker trips the watchdog, which fails what is in flight, restarts the
  worker and replays every program of every model (capturing nothing)
  before ready comes back; consecutive batch failures open the breaker.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cache.content import tree_fingerprint
from ..chaos import chaos_from_env
from ..csrc import build as kernels
from ..models.helpers import load_state_dict
from ..ops import depthwise as dw
from ..params import image_max_height, img_mean, img_num as _default_img_num, \
    img_std
from .batcher import MicroBatcher, Request, pick_bucket
from .metrics import ServingMetrics, note_capture
from .quant import (canonical_mode, module_forward, ptq_names,
                    quant_summary, quantized_store, resident_bytes,
                    strip_module)
from .resilience import (CircuitBreaker, EngineStalled, NonFiniteScores,
                         ServeWatchdog, torn_copy)
from .warmstart import WarmstartMiss

_logger = logging.getLogger(__name__)

__all__ = ["InferenceEngine", "DEFAULT_BUCKETS", "capture_program"]

DEFAULT_BUCKETS = (1, 4, 16, 64)

#: checkpoint filenames the reload watcher considers (the train runner's
#: ``.pth.tar``, plain ``.pth`` / ``.pt``); ``.tmp`` renames in flight and
#: logs are ignored
_CKPT_SUFFIXES = (".pth", ".tar", ".pt")

#: the kernel wrappers whose launches a capture records, by kernel name
_COUNTED = {"depthwise_fwd": dw.fused_depthwise}


def _params_fingerprint(state: Mapping[str, Any], dtype: str) -> str:
    """Stable hex digest of a state dict: the weight identity the verdict
    cache keys on and ``/readyz`` exposes (every tensor's name, dtype,
    shape and bytes, plus the serving dtype)."""
    return tree_fingerprint(
        ((k, torch.as_tensor(v).detach().cpu().numpy())
         for k, v in sorted(state.items())), extra=(dtype,))


def _host_shapes(state: Mapping[str, Any]) -> Dict[str, Tuple]:
    return {k: (tuple(torch.as_tensor(v).shape),
                str(torch.as_tensor(v).dtype)) for k, v in state.items()}


def capture_program(fn, x: torch.Tensor, *, pool, stream: torch.cuda.Stream,
                    lock) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[str, int]]:
    """Capture ``fn(x)`` as a CUDA graph: one eager run on ``stream`` (the
    first-use work a capture may not hold: kernel builds, the TMA encoder's
    lookup, ``cudaFuncSetAttribute``, cuDNN's choice), then, holding
    ``lock``, the capture on ``stream`` into ``pool``.  Returns the graph,
    its static output and the kernel launches counted while it was
    captured; counts one capture (``note_capture``).  A failing capture
    raises."""
    with torch.no_grad():
        # the eager run needs no lock: its memory is the caching
        # allocator's and its stream is not the serving stream
        stream.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(stream):
            fn(x)
    with lock, torch.no_grad():
        torch.cuda.synchronize(x.device)
        before = {k: w.launches for k, w in _COUNTED.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn(x)
        launches = {k: w.launches - before[k] for k, w in _COUNTED.items()
                    if w.launches > before[k]}
        note_capture()
    return graph, out, launches


class _Program:
    """One (model, bucket, chans) scoring program: ``fn`` maps an NHWC wire
    batch to softmax scores.  On the card ``graph`` replays ``fn`` captured
    over the static ``x`` into the static ``out``, and ``launches`` holds
    the kernel launches counted while it was captured; on the CPU ``fn``
    runs eagerly.  ``replays`` counts its runs."""

    __slots__ = ("bucket", "chans", "fn", "x", "out", "graph", "launches",
                 "replays", "free")

    def __init__(self, bucket: int, chans: int, fn, x=None, out=None,
                 graph=None, launches=None):
        self.bucket = bucket
        self.chans = chans
        self.fn = fn
        self.x = x
        self.out = out
        self.graph = graph
        self.launches: Dict[str, int] = dict(launches or {})
        self.replays = 0
        self.free: List[_Slot] = []     # host slots no batch holds


class _Slot:
    """Host buffers of one batch of a program: the input rows (pinned on
    the card), the scores copied out after the replay and the event
    recorded after that copy (None on the CPU)."""

    __slots__ = ("x", "x_np", "out", "out_np", "event")

    def __init__(self, x_shape, x_dtype, out_shape,
                 device: torch.device):
        pin = device.type == "cuda"
        self.x = torch.empty(x_shape, dtype=x_dtype, pin_memory=pin)
        self.x_np = self.x.numpy()
        self.out = torch.empty(out_shape, dtype=torch.float32,
                               pin_memory=pin) if pin else None
        self.out_np = None if self.out is None else self.out.numpy()
        self.event = torch.cuda.Event() if pin else None


class _ModelEntry:
    """One served model: module, geometry, programs, reload and canary
    state.  The engine's model table maps ``model_id`` → entry."""

    __slots__ = ("model_id", "model", "image_size", "img_num", "dtype",
                 "multi_frame", "var_shapes", "mean", "std", "mean_multi",
                 "std_multi", "compiled", "golden", "golden_ref",
                 "fingerprint", "reload_count", "last_reload_key",
                 "reload_attempts", "watcher", "warmed", "candidate",
                 "bf16_names", "int8_names", "store", "candidate_store")

    def __init__(self, model_id: str, model: torch.nn.Module, *,
                 image_size: int, img_num: int, dtype: str,
                 wire: str, multi_frame: bool):
        self.model_id = model_id
        self.model = model.eval()
        self.image_size = int(image_size)
        self.img_num = int(img_num)
        self.dtype = canonical_mode(dtype)
        # multi-frame needs a second program per bucket only on the uint8
        # wire (float32 payloads share the (·, ·, 3·img_num) shape)
        self.multi_frame = bool(multi_frame) and wire == "uint8" \
            and self.img_num > 1
        state = model.state_dict()
        # the shape gate of every reload
        self.var_shapes = _host_shapes(state)
        device = next(model.parameters()).device
        self.bf16_names, self.int8_names = ptq_names(
            state, dict(model.named_parameters()))
        #: the resident quantized tensors (None at f32): int8 values +
        #: scales, or bf16; the module keeps no f32 copy of them
        self.store: Optional[Dict[str, Any]] = self.quantize(state, device)
        self.candidate_store: Optional[Dict[str, Any]] = None
        self.mean = torch.as_tensor(img_mean, device=device)
        self.std = torch.as_tensor(img_std, device=device)
        # multi-frame wire: mean/std tiled to the 3·img_num clip channels
        # so the SAME per-element arithmetic runs whether the channels
        # came from replication or img_num distinct frames
        self.mean_multi = torch.as_tensor(np.tile(img_mean, self.img_num),
                                          device=device)
        self.std_multi = torch.as_tensor(np.tile(img_std, self.img_num),
                                         device=device)
        self.compiled: Dict[Tuple[int, int], _Program] = {}
        self.golden: Optional[np.ndarray] = None
        self.golden_ref: Optional[np.ndarray] = None
        # weight identity: part of every verdict-cache key, re-assigned
        # atomically with the weights by a reload commit
        self.fingerprint = _params_fingerprint(state, self.dtype)
        self.reload_count = 0
        self.last_reload_key: Optional[Tuple[str, float, int]] = None
        self.reload_attempts = 0           # torn_reload chaos step counter
        self.watcher: Optional[threading.Thread] = None
        self.warmed = False
        # the reload canary's module (a copy of the architecture, made at
        # the first reload): candidates never touch the live tensors
        self.candidate: Optional[torch.nn.Module] = None
        if self.store is not None:
            strip_module(self.model, self.store)

    def quantize(self, state: Mapping[str, Any], device: torch.device
                 ) -> Optional[Dict[str, Any]]:
        """The quantized tensors of ``state`` at this entry's dtype, on
        ``device`` (None at f32)."""
        return quantized_store(state, self.dtype, bf16_names=self.bf16_names,
                               int8_names=self.int8_names, device=device)

    def resident_bytes(self) -> int:
        """Device bytes of the weights: the module's own tensors (not the
        stripped ones) plus the quantized store."""
        live = {k: v for k, v in self.model.state_dict().items()
                if v.device.type != "meta"}
        return resident_bytes(live) + resident_bytes(self.store or {})


class _Staged:
    __slots__ = ("requests", "prog", "slot", "bucket", "dispatch_t", "seq",
                 "model_id")

    def __init__(self, requests: List[Request], prog: _Program, slot: _Slot,
                 bucket: int, dispatch_t: float, seq: int, model_id: str):
        self.requests = requests
        self.prog = prog
        self.slot = slot
        self.bucket = bucket
        self.dispatch_t = dispatch_t
        self.seq = seq          # device-batch sequence (the chaos step)
        self.model_id = model_id


class InferenceEngine:
    """The JAX engine's surface, but a model is a module on the engine's
    device with its weights loaded (the JAX engine takes a variables
    tree); the CUDA device makes the programs CUDA graphs."""

    def __init__(self, model: torch.nn.Module, *,
                 image_size: int = image_max_height,
                 img_num: int = _default_img_num,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 metrics: Optional[ServingMetrics] = None,
                 wire: str = "float32",
                 multi_frame: bool = True,
                 warmup: bool = True,
                 dtype: str = "f32",
                 model_id: str = "default",
                 watchdog_timeout_s: float = 30.0,
                 breaker_threshold: int = 5,
                 breaker_open_s: float = 5.0,
                 reload_drift_tol: float = -1.0,
                 retry_jitter_s: float = 2.0,
                 warmstart=None,
                 warm_priority: Optional[Sequence[int]] = None,
                 chaos=None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets {buckets}")
        #: warm-start store (serving/warmstart.py) or None: warmup holds
        #: every capture of a stored unit to its manifest's golden scores
        self.warmstart = warmstart
        self._warm_priority = tuple(int(b) for b in (warm_priority or ()))
        bad = [b for b in self._warm_priority if b not in self.buckets]
        if bad:
            raise ValueError(
                f"warm_priority {bad} not in buckets {self.buckets}")
        #: readiness phase: cold -> degraded (staged warmup: priority
        #: bucket serving, rest warming in background) -> ready
        self._phase = "cold"
        self._warm_thread: Optional[threading.Thread] = None
        #: per-unit program walls (eager run + capture) and the last
        #: warmup's wall; keys are (bucket, chans)
        self.warm_compile_walls: Dict[Tuple[int, int], float] = {}
        self.last_warmup_wall = 0.0
        if wire not in ("float32", "uint8"):
            raise ValueError(f"wire must be float32|uint8, got {wire!r}")
        self.wire = wire
        self._multi_frame_opt = bool(multi_frame)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.device = next(model.parameters()).device
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"the engine serves on cuda or cpu, got "
                             f"{self.device}")
        self.graphs = self.device.type == "cuda"
        if self.graphs:
            # f32 means f32: cuDNN convolutions would otherwise run in
            # TF32, which the CLI does not
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            #: every device sequence runs on this stream, in the order
            #: it was enqueued
            self._stream = torch.cuda.Stream(self.device)
            #: one memory pool for all captures of this engine, and one
            #: stream they are made on (the caching allocator reuses a
            #: freed block only on the stream that allocated it)
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        #: held around each capture and each enqueued device sequence (see
        #: the module docstring); never taken while waiting for a result,
        #: and _recover_lock is never acquired while it is held
        self._device_lock = threading.RLock()
        # the model table; insertion order is stable, the FIRST entry is
        # the primary (default-routed) model
        self._models: Dict[str, _ModelEntry] = {}
        self.default_model_id = str(model_id)
        #: authoritative in-flight ledger — staged sub-batches live here
        #: from dispatch until completion, so the stuck-batch watchdog
        #: can read the oldest dispatch time even while the worker is
        #: blocked inside a completion
        self._pending: List[_Staged] = []
        self._pending_lock = threading.Lock()
        # reload box: latest submitted host state dict per model id
        self._reload_box: Dict[str, Tuple[Any, str]] = {}
        self._reload_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._batcher: Optional[MicroBatcher] = None
        # resilience: chaos injector, worker generations, breaker, watchdog
        self.chaos = chaos if chaos is not None else chaos_from_env()
        self._gen = 0                      # bumped by every recovery; a
        # stale worker checks it before touching shared state
        self._batch_seq = 0                # device-batch counter (chaos step)
        self._recover_lock = threading.Lock()
        self.reload_drift_tol = float(reload_drift_tol)
        self.breaker = CircuitBreaker(breaker_threshold, breaker_open_s,
                                      metrics=self.metrics,
                                      retry_jitter_s=retry_jitter_s)
        self.watchdog = ServeWatchdog(
            watchdog_timeout_s, self._oldest_dispatch, self._worker_alive,
            self._recover)
        # a recovery re-warm against a TRULY hung device would block the
        # watchdog thread forever — run it bounded
        self._rewarm_timeout_s = max(30.0, 4.0 * float(watchdog_timeout_s))
        self._rewarm_thread: Optional[threading.Thread] = None
        self._canary_hook = None           # test seam: runs mid-canary
        #: verdict cache (cache/store.py VerdictCache), attached by the
        #: runner; start() hands it (plus the fingerprint resolver) to
        #: the batcher, and a reload commit purges the orphaned entries
        self.verdict_cache = None

        self.add_model(self.default_model_id, model,
                       image_size=image_size, img_num=img_num, dtype=dtype)
        if warmup:
            self.warmup()

    # ------------------------------------------------------------------
    # model table
    # ------------------------------------------------------------------
    def add_model(self, model_id: str, model: torch.nn.Module, *,
                  image_size: Optional[int] = None,
                  img_num: Optional[int] = None,
                  dtype: str = "f32") -> None:
        """Register one more model (a module on the engine's device, with
        its weights loaded).  Readiness DROPS until :meth:`warmup` has made
        and run the new entry's programs."""
        model_id = str(model_id)
        dtype = canonical_mode(dtype)
        device = next(model.parameters()).device
        if device != self.device:
            raise ValueError(f"model {model_id!r} is on {device}; this "
                             f"engine serves on {self.device}")
        # table mutation rides the recovery lock: the watchdog's recovery
        # (and its re-warm probe) iterates this dict from another thread
        with self._recover_lock:
            if model_id in self._models:
                raise ValueError(
                    f"model id {model_id!r} already registered")
            primary = next(iter(self._models.values()), None)
            entry = _ModelEntry(
                model_id, model,
                image_size=(image_size if image_size is not None
                            else (primary.image_size if primary
                                  else image_max_height)),
                img_num=(img_num if img_num is not None
                         else (primary.img_num if primary
                               else _default_img_num)),
                dtype=dtype, wire=self.wire,
                multi_frame=self._multi_frame_opt)
            self._models[model_id] = entry
        self.metrics.ready = False         # one cold model => not ready
        if entry.store is not None:
            _logger.info("model %r quantized to %s: %s", model_id,
                         entry.dtype, quant_summary(entry.store))

    def entry(self, model_id: Optional[str] = None) -> _ModelEntry:
        """The table entry for ``model_id`` (None = primary); unknown ids
        are a loud error, never a fallback to some other model."""
        if model_id is None:
            model_id = self.default_model_id
        try:
            return self._models[model_id]
        except KeyError:
            raise ValueError(
                f"unknown model {model_id!r}; this engine serves "
                f"{self.model_ids()}") from None

    def has_model(self, model_id: str) -> bool:
        return model_id in self._models

    def model_fingerprint(self, model_id: Optional[str] = None) -> str:
        """The checkpoint fingerprint of one model (None = primary)."""
        return self.entry(model_id).fingerprint

    def model_ids(self) -> Tuple[str, ...]:
        return tuple(self._models)

    @property
    def model(self) -> torch.nn.Module:
        """The primary model's module."""
        return self.entry().model

    @property
    def reload_count(self) -> int:
        return sum(e.reload_count for e in self._models.values())

    # ------------------------------------------------------------------
    # wire / program shapes
    # ------------------------------------------------------------------
    def _entry_wire_spec(self, entry: _ModelEntry) -> Tuple[int, Any]:
        """(channels, dtype) of one SINGLE-frame wire sample."""
        if self.wire == "uint8":
            return 3, np.uint8
        return 3 * entry.img_num, np.float32

    def _entry_chans(self, entry: _ModelEntry) -> Tuple[int, ...]:
        """Channel widths this entry has programs for: the single-frame
        wire width plus, on a multi-frame uint8 wire, the clip width."""
        base, _ = self._entry_wire_spec(entry)
        if entry.multi_frame:
            return (base, 3 * entry.img_num)
        return (base,)

    def _make_program(self, entry: _ModelEntry, chans: int,
                      model: Optional[torch.nn.Module] = None,
                      store: Optional[Mapping[str, Any]] = None):
        """The score function of one (model, channel width): NHWC wire
        batch → softmax scores.  The uint8 wire normalizes (+ replicates)
        with the JAX ``_score``'s elementwise float32 arithmetic; the
        model sees an NCHW view in channels_last memory, as in the CLI.
        ``model`` defaults to the entry's live module and its resident
        store; a quantized store is realized inside the function."""
        if model is None:
            model, store = entry.model, entry.store
        model = module_forward(model, store)
        if self.wire == "uint8":
            n_rep = entry.img_num if chans == 3 else 1
            mean, std = ((entry.mean, entry.std) if chans == 3
                         else (entry.mean_multi, entry.std_multi))

            def _score(x_u8: torch.Tensor) -> torch.Tensor:
                x = (x_u8.float() - mean) / std
                if n_rep > 1:
                    x = x.repeat(1, 1, 1, n_rep)
                return torch.softmax(model(x.permute(0, 3, 1, 2)), dim=-1)
        else:
            def _score(x: torch.Tensor) -> torch.Tensor:
                return torch.softmax(model(x.permute(0, 3, 1, 2)), dim=-1)
        return _score

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        return self.metrics.compiles_total.value

    @property
    def ready(self) -> bool:
        return self.metrics.ready

    def launch_counts(self) -> Dict[str, int]:
        """Kernel launches made by replays so far: per program, the
        launches counted while it was captured times its replays."""
        out: Dict[str, int] = {}
        for entry in list(self._models.values()):
            for prog in list(entry.compiled.values()):
                for name, n in prog.launches.items():
                    out[name] = out.get(name, 0) + n * prog.replays
        return out

    def _wire_dtype(self, entry: _ModelEntry) -> torch.dtype:
        return torch.uint8 if self._entry_wire_spec(entry)[1] == np.uint8 \
            else torch.float32

    def _build_program(self, entry: _ModelEntry, bucket: int,
                       chans: int) -> None:
        """Make one program: on the CPU the eager function; on the card its
        eager run on a side stream, then its capture (see the module
        docstring).  A failing capture raises."""
        t0 = time.monotonic()
        fn = self._make_program(entry, chans)
        if not self.graphs:
            prog = _Program(bucket, chans, fn)
        else:
            s = entry.image_size
            x = torch.zeros((bucket, s, s, chans),
                            dtype=self._wire_dtype(entry), device=self.device)
            graph, out, launches = capture_program(
                fn, x, pool=self._pool, stream=self._capture_stream,
                lock=self._device_lock)
            prog = _Program(bucket, chans, fn, x=x, out=out, graph=graph,
                            launches=launches)
        entry.compiled[(bucket, chans)] = prog
        wall = time.monotonic() - t0
        self.warm_compile_walls[(bucket, chans)] = wall
        self.metrics.compiles_total.inc()
        _logger.info("model %r bucket %d (%dch) %s in %.2fs",
                     entry.model_id, bucket, chans,
                     "captured" if self.graphs else "ready (eager, CPU)",
                     wall)

    def _acquire(self, entry: _ModelEntry, prog: _Program) -> _Slot:
        """A host slot of ``prog`` no batch holds (a new one if all are
        in flight)."""
        with self._device_lock:
            if prog.free:
                return prog.free.pop()
            s = entry.image_size
            return _Slot((prog.bucket, s, s, prog.chans),
                         self._wire_dtype(entry),
                         None if prog.out is None else tuple(prog.out.shape),
                         self.device)

    def _serving(self):
        """Context of the engine's device work: the device lock, no
        autograd, and on the card the serving stream."""
        stack = contextlib.ExitStack()
        stack.enter_context(self._device_lock)
        stack.enter_context(torch.no_grad())
        if self.graphs:
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _launch(self, prog: _Program, slot: _Slot) -> None:
        """Enqueue one batch of ``prog`` from ``slot``'s filled input: on the
        card copy in, replay, copy the scores out and record the event, on
        the serving stream; on the CPU run the program now."""
        with self._serving():
            prog.replays += 1
            if not self.graphs:
                slot.out_np = prog.fn(torch.from_numpy(slot.x_np)).numpy()
                return
            prog.x.copy_(slot.x, non_blocking=True)
            prog.graph.replay()
            slot.out.copy_(prog.out, non_blocking=True)
            slot.event.record(self._stream)

    @staticmethod
    def _slot_ready(slot: _Slot) -> bool:
        return slot.event is None or slot.event.query()

    def _collect(self, prog: _Program, slot: _Slot) -> np.ndarray:
        """Wait for ``slot``'s scores, copy them and give the slot back."""
        if slot.event is not None:
            slot.event.synchronize()
        scores = np.array(slot.out_np, copy=True)
        with self._device_lock:
            prog.free.append(slot)
        return scores

    def _run(self, entry: _ModelEntry, bucket: int, chans: int,
             x: np.ndarray) -> np.ndarray:
        """Scores of one full ``(bucket, s, s, chans)`` wire batch through
        the program, synchronously."""
        prog = entry.compiled[(bucket, chans)]
        slot = self._acquire(entry, prog)
        slot.x_np[...] = x
        self._launch(prog, slot)
        return self._collect(prog, slot)

    def _eager_scores(self, entry: _ModelEntry, model: torch.nn.Module,
                      chans: int, x: np.ndarray,
                      store: Optional[Mapping[str, Any]] = None
                      ) -> np.ndarray:
        """Scores of ``model`` (the reload candidate) with its quantized
        ``store`` on one wire batch, run eagerly on the serving stream:
        never a graph, never the live tensors."""
        fn = self._make_program(entry, chans, model, store)
        with self._serving():
            return fn(torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device)).cpu().numpy()

    # ------------------------------------------------------------------
    # readiness / warmup
    # ------------------------------------------------------------------
    def readiness_detail(self) -> Dict[str, Any]:
        """The ``/readyz`` JSON body: per-model readiness + the health
        signals a fleet router scrapes (the JAX engine's keys)."""
        return {
            "ready": bool(self.metrics.ready),
            "phase": self._phase,
            "models": {
                mid: {"warmed": e.warmed,
                      "image_size": e.image_size,
                      "img_num": e.img_num,
                      "dtype": e.dtype,
                      "fingerprint": e.fingerprint,
                      "reloads": e.reload_count,
                      "warm_buckets": sorted(
                          {b for (b, _c) in list(e.compiled)})}
                for mid, e in list(self._models.items())},
            "breaker": self.breaker.state,
            "queue_depth": int(self.metrics.queue_depth),
            "inflight": int(self.metrics.inflight),
        }

    def warm_report(self) -> Dict[str, Any]:
        """What warmup made of the kernel libraries (each one's store books
        and nvcc runs, ``csrc/build.library_counts``) and the kernel
        launches each program's capture recorded, by model and
        ``<bucket>x<chans>``."""
        return {"kernels": kernels.library_counts(),
                "capture_launches": {
                    mid: {f"{b}x{c}": dict(p.launches) for (b, c), p in
                          sorted(list(e.compiled.items()),
                                 key=lambda kv: kv[0])}
                    for mid, e in list(self._models.items())}}

    def _warm_order(self) -> Tuple[int, ...]:
        """Bucket warm order: the configured priority first, remaining
        buckets smallest-first."""
        rest = [b for b in self.buckets if b not in self._warm_priority]
        return self._warm_priority + tuple(rest)

    def warmup(self, staged: bool = False) -> None:
        """Make every (model, bucket, chans) program — capture it on the
        card — and run each once, then flip ready.  Idempotent per entry:
        on a warmed engine only a new entry's programs are made.

        ``staged=True`` makes only the FIRST priority bucket before
        declaring readiness (phase ``degraded``) and the rest on a
        background thread, flipping the phase to ``ready`` when the full
        set is live.  A recovery firing mid-stage aborts the background
        warm."""
        gen = self._gen
        t0 = time.monotonic()
        compile0 = self.metrics.warmup_seconds["compile"]
        order = self._warm_order()
        first, rest = order[:1], order[1:]
        # snapshot: a concurrent add_model may grow the table mid-loop
        for entry in list(self._models.values()):
            self._warm_entry(entry, buckets=(first if staged and rest
                                             else order))
        # only the generation that was current for the WHOLE warmup may
        # declare readiness — a recovery in between owns the flag
        with self._recover_lock:
            if gen == self._gen:
                self._phase = "degraded" if staged and rest else "ready"
                self.metrics.ready = True
        self.last_warmup_wall = time.monotonic() - t0
        self.metrics.warmup_seconds["warm"] += max(
            0.0, self.last_warmup_wall
            - (self.metrics.warmup_seconds["compile"] - compile0))
        if staged and rest:
            t = threading.Thread(target=self._warm_rest,
                                 args=(gen, rest), daemon=True,
                                 name="serving-warm-bg")
            self._warm_thread = t
            t.start()

    def _warm_rest(self, gen: int, buckets: Tuple[int, ...]) -> None:
        """Background half of a staged warmup: one bucket at a time, so
        dispatch sees capacity grow between buckets, not after all."""
        try:
            for b in buckets:
                if gen != self._gen or self._stop.is_set():
                    return             # a recovery owns readiness now
                for entry in list(self._models.values()):
                    self._warm_entry(entry, buckets=(b,))
            with self._recover_lock:
                if gen == self._gen:
                    self._phase = "ready"
        except Exception:                              # noqa: BLE001
            _logger.exception("staged warmup: background bucket warm "
                              "failed; engine stays degraded on the "
                              "already-warm buckets")

    def _warm_golden_input(self, entry: _ModelEntry, bucket: int,
                           chans: int) -> np.ndarray:
        """Deterministic canary input for one (bucket, chans) (the JAX
        engine's seed and draws)."""
        s = entry.image_size
        _, dtype = self._entry_wire_spec(entry)
        rng = np.random.default_rng(0xCA9A87)
        if np.dtype(dtype) == np.uint8:
            return rng.integers(0, 256, (bucket, s, s, chans),
                                dtype=np.uint8)
        return rng.random((bucket, s, s, chans), dtype=np.float32)

    def _warm_entry(self, entry: _ModelEntry,
                    buckets: Optional[Sequence[int]] = None) -> None:
        """Make one entry's programs for ``buckets`` (None = the full warm
        order), run every new one once, hold each to the warm-start store
        (canary on a hit, save on a miss), then take the golden
        baseline."""
        warm_buckets = tuple(buckets) if buckets is not None \
            else self._warm_order()
        s = entry.image_size
        _, dtype = self._entry_wire_spec(entry)
        units = [(b, chans) for chans in self._entry_chans(entry)
                 for b in warm_buckets if (b, chans) not in entry.compiled]
        t_compile0 = time.monotonic()
        libs0 = kernels.store_totals()
        for unit in units:
            self._build_program(entry, *unit)
        self.metrics.warmup_seconds["compile"] += \
            time.monotonic() - t_compile0
        for b, chans in units:
            self._run(entry, b, chans, np.zeros((b, s, s, chans), dtype))
        if self.warmstart is not None:
            self._warm_store(entry, units)
        # the kernel libraries' store books, built during these captures
        libs = kernels.store_totals() - libs0
        for key, counter in (
                ("hits", self.metrics.warmstart_hits_total),
                ("misses", self.metrics.warmstart_misses_total),
                ("fallbacks", self.metrics.warmstart_fallbacks_total),
                ("canary_rejects",
                 self.metrics.warmstart_canary_rejects_total),
                ("serialized", self.metrics.warmstart_serialized_total)):
            if libs[key]:
                counter.inc(libs[key])
        # golden canary batch: a fixed seeded input whose scores under the
        # CURRENT weights baseline the reload canary (and its drift
        # tolerance), tied to the smallest bucket
        base_chans, _ = self._entry_wire_spec(entry)
        if (self.buckets[0], base_chans) in entry.compiled:
            if entry.golden is None:
                entry.golden = self._warm_golden_input(
                    entry, self.buckets[0], base_chans)
            entry.golden_ref = self._run(entry, self.buckets[0],
                                         base_chans, entry.golden)
        entry.warmed = True

    # ------------------------------------------------------------------
    # warm-start store
    # ------------------------------------------------------------------
    def _store_fields(self, entry: _ModelEntry, bucket: int,
                      chans: int) -> Dict[str, Any]:
        """The complete store key fields of one capture (see
        serving/warmkey.py).  The program hash digests the module's repr,
        the state_dict's (name, shape, dtype) (weights are not in it:
        checkpoints of one architecture share entries), the normalization
        constants and the kernel libraries' source digests."""
        from . import warmkey
        h = hashlib.sha256()
        h.update(repr(entry.model).encode())
        for name, shape in sorted(entry.var_shapes.items()):
            h.update(f"{name}{shape}".encode())
        for a in (entry.mean, entry.std, entry.mean_multi, entry.std_multi):
            h.update(a.detach().cpu().numpy().tobytes())
        for digest in kernels.library_digests():
            h.update(digest.encode())
        if self.graphs:
            major, minor = torch.cuda.get_device_capability(self.device)
            kind, capability = (torch.cuda.get_device_name(self.device),
                                f"{major}.{minor}")
        else:
            kind, capability = "cpu", ""
        return warmkey.key_fields(
            device_kind=kind, capability=capability, program=h.hexdigest(),
            geometry={"image_size": entry.image_size,
                      "img_num": entry.img_num,
                      "multi_frame": entry.multi_frame,
                      "model_class": type(entry.model).__name__},
            bucket=bucket, chans=chans, wire=self.wire, quant=entry.dtype)

    def _warm_store(self, entry: _ModelEntry,
                    units: Sequence[Tuple[int, int]]) -> None:
        """Hold each new unit to the store: on a manifest hit the golden
        canary, on a miss or a fallback a save; a reject recaptures every
        unit (on rebuilt libraries) and saves the rejected units over."""
        rejected = []
        for unit in units:
            fields = self._store_fields(entry, *unit)
            try:
                manifest = self.warmstart.load(fields)
            except WarmstartMiss as e:
                if e.reason == "absent":
                    self.metrics.warmstart_misses_total.inc()
                else:
                    self.metrics.warmstart_fallbacks_total.inc()
                    _logger.warning("warmstart: %s bucket %d (%dch): %s",
                                    entry.model_id, unit[0], unit[1], e)
                self._store_save(entry, unit, fields)
                continue
            self.metrics.warmstart_hits_total.inc()
            if not self._warm_canary(entry, unit, fields, manifest):
                rejected.append((unit, fields))
        if rejected:
            self._recapture_all()
            for unit, fields in rejected:
                self._store_save(entry, unit, fields)

    def _warm_canary(self, entry: _ModelEntry, unit: Tuple[int, int],
                     fields: Dict[str, Any],
                     manifest: Dict[str, Any]) -> bool:
        """Golden-batch gate of one capture of a stored unit: finite,
        shape-correct scores and, when the manifest was written under the
        entry's checkpoint (the fingerprint matches), bitwise the manifest's.
        A fingerprint-skewed entry that passes has its manifest re-stamped
        so the next same-checkpoint start regains the bitwise gate."""
        from . import warmkey
        bucket, chans = unit
        why = ""
        scores = None
        try:
            scores = self._run(entry, bucket, chans, self._warm_golden_input(
                entry, bucket, chans))
        except Exception as e:                         # noqa: BLE001
            why = f"replay failed: {e}"
        if why == "" and (scores.ndim != 2 or scores.shape[0] != bucket):
            why = f"scores shape {scores.shape} for bucket {bucket}"
        if why == "" and not np.isfinite(scores).all():
            why = "non-finite scores"
        same_ckpt = manifest.get("params_fingerprint") == entry.fingerprint
        if why == "" and same_ckpt:
            try:
                ref = warmkey.decode_array(manifest["golden_scores"])
            except Exception as e:                     # noqa: BLE001
                why = f"manifest golden scores unreadable: {e}"
            else:
                if ref.shape != scores.shape or \
                        not np.array_equal(ref, scores):
                    why = ("scores not bitwise the manifest's (same "
                           "checkpoint fingerprint)")
        if why:
            self.metrics.warmstart_canary_rejects_total.inc()
            _logger.error("warmstart: canary REJECTED the capture of %s "
                          "bucket %d (%dch): %s; recapturing every unit",
                          entry.model_id, bucket, chans, why)
            return False
        if not same_ckpt:
            self.warmstart.refresh_manifest(
                fields, golden_scores=scores,
                params_fingerprint=entry.fingerprint)
        return True

    def _store_save(self, entry: _ModelEntry, unit: Tuple[int, int],
                    fields: Dict[str, Any]) -> None:
        scores = self._run(entry, *unit, self._warm_golden_input(entry,
                                                                 *unit))
        if self.warmstart.save(fields, golden_scores=scores,
                               params_fingerprint=entry.fingerprint):
            self.metrics.warmstart_serialized_total.inc()

    def _recapture_all(self) -> None:
        """After a canary reject: nvcc the libraries that came from the
        store again (new file names; the old ones stay mapped) and capture
        every unit of every entry again, so no graph replays a rejected
        library's functions."""
        rebuilt = kernels.rebuild_store_libraries()
        with self._recover_lock:
            entries = list(self._models.values())
        for entry in entries:
            s = entry.image_size
            _, dtype = self._entry_wire_spec(entry)
            for b, chans in sorted(entry.compiled):
                self._build_program(entry, b, chans)
                self._run(entry, b, chans, np.zeros((b, s, s, chans), dtype))
        _logger.warning("warmstart: rebuilt libraries %s and recaptured every "
                        "unit", rebuilt)

    def _rewarm(self) -> None:
        """Run every program of every model once against the serving
        weights (the recovery's proof that the device answers again): a
        replay of the EXISTING graphs, never a capture.  Snapshot the
        table: a live add_model may grow it mid-loop (the new entry's own
        warmup proves it)."""
        for entry in list(self._models.values()):
            if not entry.warmed:
                continue       # cold add_model entry: no programs yet
            s = entry.image_size
            _, dtype = self._entry_wire_spec(entry)
            for b, chans in sorted(list(entry.compiled)):
                self._run(entry, b, chans, np.zeros((b, s, s, chans),
                                                    dtype))
        self.metrics.rewarms_total.inc()

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------
    def _chans_of(self, entry: _ModelEntry, array) -> int:
        """Wire channel count of one request array, validated against the
        entry's programs (unknown widths fail loudly here)."""
        chans = int(np.shape(array)[-1]) if np.ndim(array) else 0
        if chans not in self._entry_chans(entry):
            raise ValueError(
                f"request carries {chans} channels; model "
                f"{entry.model_id!r} accepts {self._entry_chans(entry)} "
                f"(wire={self.wire}, img_num={entry.img_num}, "
                f"multi_frame={entry.multi_frame})")
        return chans

    def _warm_buckets(self, entry: _ModelEntry,
                      chans: int) -> Tuple[int, ...]:
        """Buckets with a LIVE program for this channel width — the only
        shapes dispatch may pad into."""
        avail = sorted(b for (b, c) in list(entry.compiled) if c == chans)
        return tuple(avail) if avail else self.buckets

    def _pad_batch(self, entry: _ModelEntry, arrays: List[np.ndarray],
                   chans: int) -> Tuple[_Program, _Slot, int]:
        """Rows into a host slot of the nearest bucket's program, the pad
        rows zeroed.  A streaming ``FrameStack`` payload
        (``streaming/ring.py``) gathers its frames straight from the crop
        ring into its slot row through ``write_into`` (the one copy of the
        window's life), which also releases the ring pins; anything else
        is copied in."""
        n = len(arrays)
        bucket = pick_bucket(n, self._warm_buckets(entry, chans))
        try:
            prog = entry.compiled[(bucket, chans)]
        except KeyError:
            raise ValueError(
                f"model {entry.model_id!r} has no program for bucket "
                f"{bucket} ({chans}ch); warm it first") from None
        slot = self._acquire(entry, prog)
        for i, a in enumerate(arrays):
            write_into = getattr(a, "write_into", None)
            if write_into is not None:
                write_into(slot.x_np[i])
            else:
                slot.x_np[i] = a
        slot.x_np[n:] = 0
        return prog, slot, bucket

    def score_batch(self, arrays: List[np.ndarray],
                    model_id: Optional[str] = None) -> np.ndarray:
        """Synchronous scoring of up to max-bucket wire-format samples
        against one model; one channel width per call."""
        entry = self.entry(model_id)
        chans = self._chans_of(entry, arrays[0])
        for a in arrays[1:]:
            if self._chans_of(entry, a) != chans:
                raise ValueError("score_batch arrays must share one "
                                 "channel width; the async path handles "
                                 "mixed single/multi-frame traffic")
        prog, slot, _bucket = self._pad_batch(entry, arrays, chans)
        self._launch(prog, slot)
        return self._collect(prog, slot)[:len(arrays)]

    def _stage(self, requests: List[Request]) -> List[_Staged]:
        """Dispatch requests as one device batch per (model, channel
        width), each sub-batch entering the ``_pending`` ledger at
        dispatch so the watchdog sees its age."""
        groups: Dict[Tuple[str, int], List[Request]] = {}
        for r in requests:
            # per-request validation: an unknown model id or channel
            # width must fail THAT request, never the coalesced batch
            try:
                entry = self.entry(r.model_id)
                key = (entry.model_id, self._chans_of(entry, r.array))
            except ValueError as e:
                if r.claim():
                    self.metrics.failed_total.inc()
                    self.metrics.count_model("failed", r.model_id)
                    r.set_exception(e)
                continue
            groups.setdefault(key, []).append(r)
        staged: List[_Staged] = []
        try:
            for (model_id, chans), grp in groups.items():
                entry = self._models[model_id]
                # during a staged warmup the coalesced group may exceed
                # the largest LIVE bucket: split it
                cap = self._warm_buckets(entry, chans)[-1]
                for i0 in range(0, len(grp), cap):
                    sub = grp[i0:i0 + cap]
                    seq = self._batch_seq
                    self._batch_seq += 1
                    if self.chaos.active and \
                            self.chaos.fires("serve_exc", seq):
                        self.metrics.count_chaos("serve_exc")
                        raise RuntimeError(
                            f"chaos: injected score-fn exception "
                            f"(batch {seq})")
                    prog, slot, bucket = self._pad_batch(
                        entry, [r.array for r in sub], chans)
                    self._launch(prog, slot)
                    now = time.monotonic()
                    for r in sub:
                        r.timings["queue"] = now - r.enqueue_t
                    st = _Staged(sub, prog, slot, bucket, now, seq,
                                 model_id)
                    # gauge bump + ledger entry are ONE atom vs the
                    # recovery path's clear-and-zero
                    with self._pending_lock:
                        self.metrics.inflight += len(sub)
                        self._pending.append(st)
                    staged.append(st)
        except Exception:
            # a later group poisoned the stage: the caller fails EVERY
            # request of the coalesced batch, so unwind the sub-batches
            # already dispatched
            for st in staged:
                self._unpend(st)
            raise
        return staged

    def _unpend(self, staged: _Staged) -> bool:
        """Claim a staged batch out of the in-flight ledger (with its
        inflight-gauge decrement).  False = a recovery already claimed
        it."""
        with self._pending_lock:
            try:
                self._pending.remove(staged)
            except ValueError:
                return False
            self.metrics.inflight -= len(staged.requests)
            return True

    def _complete(self, staged: _Staged, gen: int) -> None:
        if gen != self._gen:
            return                 # recovery owns these requests now
        if self.chaos.active and self.chaos.fires("serve_hang", staged.seq):
            hang_s = self.chaos.arg("serve_hang", 30.0)
            self.metrics.count_chaos("serve_hang")
            _logger.error("chaos: hanging completion of batch %d for "
                          "%.1fs", staged.seq, hang_s)
            time.sleep(hang_s)
        scores = self._collect(staged.prog, staged.slot)   # waits
        now = time.monotonic()
        if gen != self._gen or not self._unpend(staged):
            # the watchdog recovered while we were blocked: it already
            # failed these requests and zeroed the gauges — touch nothing
            return
        if self.chaos.active and self.chaos.fires("serve_nan", staged.seq):
            self.metrics.count_chaos("serve_nan")
            scores = np.full_like(scores, np.nan)
        device_dt = now - staged.dispatch_t
        n = len(staged.requests)
        m = self.metrics
        if not np.isfinite(scores[:n]).all():
            # a non-finite score is NEVER served
            m.nonfinite_batches_total.inc()
            self.breaker.record_failure()
            _logger.error("device batch %d produced non-finite scores; "
                          "failing %d request(s)", staged.seq, n)
            self._fail(staged.requests, NonFiniteScores(
                f"device batch {staged.seq} produced non-finite scores "
                f"(bucket {staged.bucket}); retry against healthy weights"))
            return
        m.batches_total.inc()
        m.batch_rows_total.inc(n)
        m.padded_rows_total.inc(staged.bucket - n)
        m.count_bucket_rows(staged.model_id, staged.bucket, n,
                            staged.bucket - n)
        m.latency["device"].observe(device_dt)
        m.count_completion(n, now)
        for i, r in enumerate(staged.requests):
            r.timings["device"] = device_dt
            m.latency["queue"].observe(r.timings.get("queue", 0.0))
            if r.claim():
                m.scored_total.inc()
                m.count_model("scored", r.model_id)
                r.set_result(scores[i])
        self.breaker.record_success()

    def _fail(self, requests: List[Request], err: BaseException) -> None:
        for r in requests:
            if r.claim():
                self.metrics.failed_total.inc()
                self.metrics.count_model("failed", r.model_id)
                r.set_exception(err)

    # ------------------------------------------------------------------
    # serve loop
    # ------------------------------------------------------------------
    def _loop_once(self, batcher: MicroBatcher, gen: int) -> None:
        if self.chaos.active and \
                self.chaos.fires("serve_kill", self._batch_seq):
            self.metrics.count_chaos("serve_kill")
            _logger.error("chaos: killing engine worker (gen %d)", gen)
            # SystemExit ends the worker thread outright; the watchdog's
            # worker-liveness probe is what must bring serving back
            raise SystemExit("chaos: serve_kill")
        self._maybe_apply_reload()
        with self._pending_lock:
            pending = list(self._pending)
        if not pending:
            # device idle: block for the first request, then coalesce
            # within the deadline window
            requests = batcher.next_batch(timeout=0.05)
            if requests:
                try:
                    self._stage(requests)
                except Exception as e:             # noqa: BLE001
                    self._fail(requests, e)        # poisoned batch: 500s
                    self.breaker.record_failure()
                    raise                          # now, not at timeout
            return
        # Device busy on batch k: its execution time is FREE coalescing
        # time — gather batch k+1 until k's result lands AND the deadline
        # window has run, or the bucket fills, then a last non-blocking
        # drain for stragglers already queued
        requests: List[Request] = []
        last = pending[-1].slot              # last sub-batch lands last
        flush_at = time.monotonic() + batcher.deadline_s
        while len(requests) < batcher.max_batch and gen == self._gen:
            if self._slot_ready(last) and time.monotonic() >= flush_at:
                break
            r = batcher.take(timeout=0.001)
            if r is not None:
                requests.append(r)
        while len(requests) < batcher.max_batch and gen == self._gen:
            r = batcher.take(timeout=0.0)
            if r is None:
                break
            requests.append(r)
        if gen != self._gen:
            # a recovery fired while we gathered: fail the dequeued
            # requests instead of stranding them
            self._fail(requests, EngineStalled(
                "engine restarted while this request was being batched"))
            return
        # dispatch k+1 BEFORE blocking on k: the copy in and replay of
        # k+1 queue behind k on the stream while the host completes k
        if requests:
            try:
                self._stage(requests)
            except Exception as e:                 # noqa: BLE001
                self._fail(requests, e)
                self.breaker.record_failure()
                raise
        err: Optional[Exception] = None
        for st in pending:
            try:
                self._complete(st, gen)
            except Exception as e:                 # noqa: BLE001
                if gen != self._gen:
                    return             # recovery already owns the ledger
                self._unpend(st)       # claim carries the gauge decrement
                self._fail(st.requests, e)
                self.breaker.record_failure()
                err = e
        if err is not None:
            raise err

    def serve_loop(self, batcher: MicroBatcher, gen: int = 0) -> None:
        """Run until stop() or a newer worker generation supersedes this
        one; never lets an exception strand requests or kill the worker
        (the injected SystemExit of serve_kill does end the thread)."""
        while not self._stop.is_set() and gen == self._gen:
            try:
                self._loop_once(batcher, gen)
            except SystemExit:
                return
            except Exception:                      # noqa: BLE001
                if gen != self._gen:
                    return
                _logger.exception("engine worker crashed; recovering")
                self.metrics.worker_restarts_total.inc()
                time.sleep(0.01)     # a persistent fault must not spin-log

    def _spawn_worker(self) -> None:
        gen = self._gen
        self._worker = threading.Thread(
            target=self.serve_loop, args=(self._batcher, gen),
            name=f"serving-engine-g{gen}", daemon=True)
        self._worker.start()

    def start(self, batcher: MicroBatcher) -> None:
        if self._batcher is not None:
            raise RuntimeError("engine already started")
        self._batcher = batcher
        # unrouted submits land on the primary model's books
        batcher.default_model_id = self.default_model_id
        batcher.fingerprint_of = self.model_fingerprint
        if self.verdict_cache is not None and batcher.cache is None:
            batcher.cache = self.verdict_cache
        self._spawn_worker()
        self.watchdog.start()

    def stop(self) -> None:
        self._stop.set()
        self.watchdog.stop()       # before the join: a recovery must not
        if self._worker is not None:    # race the shutdown
            self._worker.join(timeout=5.0)
            self._worker = None
        for entry in list(self._models.values()):
            if entry.watcher is not None:
                entry.watcher.join(timeout=5.0)
        if self._warm_thread is not None:
            self._warm_thread.join(timeout=30.0)
        with self._pending_lock:
            pending, self._pending = self._pending, []
        for st in pending:
            self._fail(st.requests, RuntimeError("server shutting down"))

    # ------------------------------------------------------------------
    # watchdog recovery (serving/resilience.py runs the monitor thread)
    # ------------------------------------------------------------------
    def _oldest_dispatch(self) -> Optional[float]:
        with self._pending_lock:
            if not self._pending:
                return None
            return min(st.dispatch_t for st in self._pending)

    def _worker_alive(self) -> bool:
        return self._worker is None or self._worker.is_alive()

    def _recover(self, reason: str) -> None:
        """Watchdog-thread recovery: fail everything in flight, retire the
        current worker generation, prove the device answers by replaying
        every program of every model (readiness stays FALSE until it
        does), then start a fresh worker.  Zero captures."""
        with self._recover_lock:
            if self._stop.is_set():
                return
            if self._rewarm_thread is not None and \
                    self._rewarm_thread.is_alive():
                # an earlier recovery's re-warm is still wedged on the
                # device: stay not-ready until it answers
                return
            _logger.error("engine recovery (%s): failing in-flight "
                          "requests, restarting worker, re-warming %d "
                          "bucket(s) x %d model(s)", reason,
                          len(self.buckets), len(self._models))
            self.metrics.ready = False
            self.metrics.watchdog_recoveries_total.inc()
            self.breaker.record_failure()
            self._gen += 1         # neuters the old worker's late writes
            with self._pending_lock:
                pending, self._pending = self._pending, []
                self.metrics.inflight = 0
            for st in pending:
                self._fail(st.requests, EngineStalled(
                    f"engine recovery ({reason}) abandoned this batch"))
            # bounded re-warm on a helper thread: against a genuinely
            # hung device the wait never returns, and the watchdog thread
            # must stay free to keep polling (and to let stop() shut down)
            done = threading.Event()

            def _rewarm_probe():
                try:
                    self._rewarm()
                    done.set()
                except Exception:                  # noqa: BLE001
                    _logger.exception("post-recovery re-warm failed; "
                                      "engine stays not-ready")

            t = threading.Thread(target=_rewarm_probe, daemon=True,
                                 name="serving-rewarm")
            self._rewarm_thread = t
            t.start()
            deadline = time.monotonic() + self._rewarm_timeout_s
            while not done.wait(0.2):
                if self._stop.is_set():
                    return
                if time.monotonic() > deadline:
                    _logger.error(
                        "post-recovery re-warm still blocked after %.0fs "
                        "(device wedged?); engine stays not-ready",
                        self._rewarm_timeout_s)
                    return
                if not t.is_alive() and not done.is_set():
                    return             # probe raised; already logged
            self._rewarm_thread = None
            if self._batcher is not None:
                self._spawn_worker()
            self.metrics.ready = True
            _logger.info("engine recovered (%s): worker gen %d serving, "
                         "programs re-warmed", reason, self._gen)

    # ------------------------------------------------------------------
    # hot weight reload
    # ------------------------------------------------------------------
    def submit_reload(self, host_state: Mapping[str, Any],
                      source: str = "<api>",
                      model_id: Optional[str] = None) -> None:
        """Queue a host state dict (name → tensor or array) for an atomic
        between-batch swap of one model's weights (called by the watcher
        threads, or directly in tests)."""
        if model_id is None:
            model_id = self.default_model_id
        with self._reload_lock:
            self._reload_box[model_id] = (host_state, source)

    def _maybe_apply_reload(self) -> None:
        with self._reload_lock:
            if not self._reload_box:
                return
            model_id, (host_state, source) = self._reload_box.popitem()
        try:
            entry = self.entry(model_id)
        except ValueError:
            _logger.error("reload for unknown model %r dropped", model_id)
            self.metrics.reload_errors_total.inc()
            return
        # readiness drops for the canary window (/healthz stays up); `gen`
        # is captured so a watchdog recovery firing mid-canary wins every
        # race: the stale worker requeues the reload for the fresh one
        gen = self._gen
        was_ready = self.metrics.ready
        self.metrics.ready = False
        try:
            if self._canary_hook is not None:      # test seam
                self._canary_hook()
            try:
                if _host_shapes(host_state) != entry.var_shapes:
                    # a checkpoint of some OTHER model lands here too:
                    # cross-model swaps are rejected loudly
                    raise ValueError(
                        f"checkpoint tree/shape mismatch vs serving "
                        f"model {entry.model_id!r}")
                # the candidate is quantized to the entry's dtype first:
                # the canary gates the weights as they will serve (NaN
                # after dequantizing, drifted scores)
                candidate, cstore = self._load_candidate(entry, host_state)
                canary = self._canary_scores(entry, candidate, cstore)
                new_fp = _params_fingerprint(host_state, entry.dtype)
            except Exception:                      # noqa: BLE001
                _logger.exception("hot reload of model %r from %s "
                                  "rejected; previous weights keep "
                                  "serving", entry.model_id, source)
                self.metrics.reload_errors_total.inc()
                return
            with self._recover_lock:   # serialize the commit vs recovery
                if gen != self._gen:
                    self.submit_reload(host_state, source,
                                       model_id=model_id)   # retry fresh
                    return
                self._commit(entry, candidate, cstore)
                if canary is not None:
                    entry.golden_ref = canary      # new drift baseline
                entry.fingerprint = new_fp
                entry.reload_count += 1
            if self.verdict_cache is not None:
                purged = self.verdict_cache.purge_model(
                    entry.model_id, keep_fingerprint=new_fp)
                if purged:
                    self.metrics.cache_invalidated_total.inc(purged)
                    self.metrics.cache_entries = self.verdict_cache.size()
            self.metrics.reloads_total.inc()
            self.metrics.count_model("reloads", entry.model_id)
            _logger.info("hot-reloaded model %r weights from %s "
                         "(reload #%d)", entry.model_id, source,
                         entry.reload_count)
        finally:
            with self._recover_lock:
                if gen == self._gen:
                    self.metrics.ready = was_ready

    def _load_candidate(self, entry: _ModelEntry,
                        host_state: Mapping[str, Any]):
        """The entry's candidate module holding ``host_state`` and the
        candidate's quantized store (None at f32); the live module and
        store are never touched.  Written on the serving stream, behind
        any commit still copying out of them."""
        with self._serving():
            if entry.candidate is None:
                entry.candidate = copy.deepcopy(entry.model).eval()
            stripped = entry.store or {}
            entry.candidate.load_state_dict(
                {k: torch.as_tensor(v) for k, v in host_state.items()
                 if k not in stripped}, strict=not stripped)
            entry.candidate_store = entry.quantize(host_state, self.device)
        return entry.candidate, entry.candidate_store

    def _commit(self, entry: _ModelEntry, candidate: torch.nn.Module,
                store: Optional[Mapping[str, Any]] = None) -> None:
        """Copy the candidate's tensors into the live ones and its
        quantized store into the resident one, in place, on the serving
        stream: the batches already dispatched ran on the old weights,
        every later one runs on the new (the graphs keep the live
        addresses)."""
        new = candidate.state_dict()
        with self._serving():
            for k, t in entry.model.state_dict().items():
                if t.device.type != "meta":
                    t.copy_(new[k], non_blocking=True)
            for k, v in (entry.store or {}).items():
                for t, src in zip(v if isinstance(v, tuple) else (v,),
                                  store[k] if isinstance(v, tuple)
                                  else (store[k],)):
                    t.copy_(src, non_blocking=True)

    def _canary_scores(self, entry: _ModelEntry,
                       candidate: torch.nn.Module,
                       store: Optional[Mapping[str, Any]] = None
                       ) -> Optional[np.ndarray]:
        """Golden-batch canary: the candidate weights must produce finite,
        shape-correct scores — and, when ``reload_drift_tol`` >= 0, scores
        within that tolerance of the serving weights' on the SAME input —
        before they may serve.  Raises on any violation."""
        chans, dtype = self._entry_wire_spec(entry)
        if entry.golden is None:                   # warmup=False engines
            s = entry.image_size
            self._eager_scores(
                entry, candidate, chans,
                np.zeros((self.buckets[0], s, s, chans), dtype), store)
            return None
        canary = self._eager_scores(entry, candidate, chans, entry.golden,
                                    store)
        if entry.golden_ref is not None and \
                canary.shape != entry.golden_ref.shape:
            self.metrics.reload_canary_failures_total.inc()
            raise ValueError(
                f"canary: golden-batch scores have shape {canary.shape}, "
                f"serving weights produce {entry.golden_ref.shape}")
        if not np.isfinite(canary).all():
            self.metrics.reload_canary_failures_total.inc()
            raise ValueError("canary: candidate weights produce "
                             "non-finite scores on the golden batch")
        if self.reload_drift_tol >= 0 and entry.golden_ref is not None:
            drift = float(np.max(np.abs(canary - entry.golden_ref)))
            if drift > self.reload_drift_tol:
                self.metrics.reload_canary_failures_total.inc()
                raise ValueError(
                    f"canary: golden-batch score drift {drift:.6g} "
                    f"exceeds --reload-drift-tol {self.reload_drift_tol}")
        return canary

    # ------------------------------------------------------------------
    def _newest_checkpoint(self, ckpt_dir: str
                           ) -> Optional[Tuple[str, float, int]]:
        try:
            names = os.listdir(ckpt_dir)
        except OSError:
            return None
        best = None
        for name in names:
            # dotfiles are never candidates (editor temps, the chaos
            # harness's torn copies)
            if name.startswith(".") or not name.endswith(_CKPT_SUFFIXES):
                continue
            path = os.path.join(ckpt_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            key = (path, st.st_mtime, st.st_size)
            if best is None or key[1] > best[1]:
                best = key
        return best

    def _watch_loop(self, ckpt_dir: str, interval_s: float,
                    use_ema: bool, model_id: str) -> None:
        entry = self.entry(model_id)
        while not self._stop.wait(interval_s):
            newest = self._newest_checkpoint(ckpt_dir)
            if newest is None or newest == entry.last_reload_key:
                continue
            path = load_path = newest[0]
            seq = entry.reload_attempts
            entry.reload_attempts += 1
            if self.chaos.active and self.chaos.fires("torn_reload", seq):
                # route the load through a half-truncated copy so the
                # REAL torn-file rejection is what recovers
                self.metrics.count_chaos("torn_reload")
                load_path = torn_copy(path, tempfile.gettempdir())
                _logger.error("chaos: reloading torn checkpoint copy %s",
                              load_path)
            try:
                loaded = load_state_dict(load_path, use_ema=use_ema)
            except Exception:                      # noqa: BLE001
                _logger.exception("reload watcher (%s): cannot load %s; "
                                  "previous weights keep serving",
                                  entry.model_id, load_path)
                self.metrics.reload_errors_total.inc()
                if load_path == path:
                    # don't re-log a genuinely corrupt file every tick —
                    # but a chaos-torn COPY leaves the real file untried
                    entry.last_reload_key = newest
                continue
            finally:
                if load_path != path:
                    try:
                        os.unlink(load_path)
                    except OSError:
                        pass
            entry.last_reload_key = newest
            self.submit_reload(loaded, source=path,
                               model_id=entry.model_id)

    def start_reload_watcher(self, ckpt_dir: str, interval_s: float = 5.0,
                             use_ema: bool = False,
                             model_id: Optional[str] = None) -> None:
        """Poll ``ckpt_dir`` for new torch checkpoints and hot-swap them
        into ``model_id``'s slot (None = the primary model).  Writers must
        rename atomically into place (``train/checkpoint.py`` does)."""
        entry = self.entry(model_id)
        if entry.watcher is not None:
            raise RuntimeError(
                f"watcher already started for model {entry.model_id!r}")
        # only files appearing AFTER start trigger a reload
        entry.last_reload_key = self._newest_checkpoint(ckpt_dir)
        entry.watcher = threading.Thread(
            target=self._watch_loop,
            args=(ckpt_dir, interval_s, use_ema, entry.model_id),
            name=f"serving-reload-watcher-{entry.model_id}", daemon=True)
        entry.watcher.start()
