"""Corpus-scale offline backfill runner: saturation-first scoring.

The counterpart of ``deepfake_detection_tpu/runners/backfill.py``.  Where
``runners/serve.py`` optimizes request latency, this runner optimizes ONE
thing: clips/s over an archived corpus.  There is no HTTP, no batcher
deadline and no per-request bookkeeping in the hot loop: a leased
manifest shard (``backfill/``) is driven through a deadline-free
pipeline at one fixed batch:

    mmap/decode (thread pool, overlapped)  →  slab memcpy into a pinned
    slot  →  uint8 wire + normalize inside ONE captured CUDA graph  →
    per-shard ``dfd.backfill.verdict.v1`` JSONL

* **One program.** The bucket's score function (the JAX ``_score``: the
  uint8 clip normalized by the tiled mean and std in f32, the model's
  eval forward, the softmax) is captured once as a CUDA graph by the
  serving engine's mechanism (``serving/engine.capture_program``: an eager
  run on a side stream, then the capture), and replayed for every batch.
  Nothing is captured after warmup: the process-wide capture count
  (``serving/metrics.capture_count``, the catalog's
  ``backend_compiles_total``) growing in steady state is the alarm, and
  the exit code.  Kernel launches are the capture's counts × replays.  On
  the CPU (``--device cpu``, the tests) the same function runs eagerly.
* **Double-buffered staging.** A producer thread assembles slab k+1 in a
  pinned host slot while batch k replays; each replay's input is copied
  from its slot into the graph's static input, its scores out into the
  slot's pinned output, and an event recorded after that copy; a slot is
  handed back for reuse only after its event.  Two batches stay in flight
  while the host books the oldest.
* **Books.** Workers lease shards atomically, heartbeat while scoring,
  and commit each shard's verdicts with an atomic done marker.  SIGTERM
  exits 75 at a batch boundary (the ``train/resilience.py`` restart
  contract) and a relaunch resumes at shard granularity; a dead host's
  lease expires by mtime and its partially written shard is re-leased,
  torn tail repaired, surviving records kept.  At corpus completion the
  books must balance EXACTLY: ``manifest clips == scored + failed +
  skipped_dup``, no clip twice, none missing; a non-finite score is booked
  as a failure.  ``--dedup`` (packed source only) hashes the pack's slabs
  first (``cache/content``): a clip whose bytes already occur earlier in
  the manifest books a ``skipped_dup`` row naming the canonical clip and
  never enters a batch.
* **Chaos points** (``DFD_CHAOS``): ``backfill_kill@N`` (a real SIGTERM to
  itself at device batch N), ``backfill_lease_race@N`` (a rival leases
  the shard of acquisition attempt N first), ``backfill_torn_shard@N``
  (half a record, then a hard exit).

* **Warm start** (``--warmstart-dir``, ``serving/warmstart.py``): the
  kernel libraries come from the store where it holds them (no nvcc), and
  the capture is held to the store's manifest of this program: bitwise
  its golden-batch scores under the same checkpoint fingerprint, else
  finite and of the right shape (the manifest is then re-stamped).  A
  reject rebuilds the store's libraries by nvcc and captures again; a miss
  or a fallback saves the manifest.  The summary's ``warmstart_source``
  is ``store`` when the manifest passed, ``compile`` otherwise, and
  ``warmstart_fallback`` names why a present entry was not used.

The JAX runner's mesh is one card here (multi-GPU is ROADMAP item 9);
``--stem-s2d`` (item 12) and the XLA-only ``--compile-cache-dir`` raise.

Usage::

    python -m deepfake_detection_tpu_torch.backfill.manifest /data/frames \\
        --manifest corpus.json --shard-clips 256 --packed /ssd/pack
    python -m deepfake_detection_tpu_torch.runners.backfill \\
        --manifest corpus.json --data-packed /ssd/pack --out run/ \\
        --model-path model.pth --batch-size 16 [--dedup] [--device cuda]
    # more workers = more processes pointing at the same run dir
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..serving.config import FlagConfig

_logger = logging.getLogger(__name__)

__all__ = ["BackfillConfig", "run_backfill", "main", "EXIT_PREEMPTED"]

EXIT_PREEMPTED = 75       # keep in sync with train/resilience.py


@dataclass
class BackfillConfig(FlagConfig):
    """Knob surface of the backfill runner: the JAX ``BackfillConfig``'s
    fields and defaults, every field a ``--dashed-flag`` (a ``-c`` YAML or
    JSON file resets the defaults, the command line overrides them), plus
    ``--device``.  No deadline, queue or wire knob: backfill always runs
    the uint8 wire at ONE fixed batch, and concurrency comes from more
    worker processes against the same ``--out`` run dir."""
    DESCRIPTION = ("corpus-scale offline backfill scoring runner (PyTorch, "
                   "one CUDA graph)")

    # --- work ---
    manifest: str = ""                   # backfill/manifest.py output
    out: str = ""                        # shared run dir (leases/, done/,
    # verdicts/, telemetry JSONL)
    data_packed: str = ""                # pack (zero-decode path)
    data: str = ""                       # v3 list roots, ':'-separated
    # (frame-tree path; exactly one of data_packed/data)

    # --- model (mirrors runners/serve.py) ---
    model: str = "efficientnet_deepfake_v4"
    model_path: str = ""                 # torch file (timm keys)
    use_ema: bool = False
    num_classes: int = 2
    # frame-tree geometry: frames per clip and the canonical square
    # resample (0 keeps native resolution, which must then be uniform);
    # a pack carries both in its index and ignores these
    frames: int = 4
    image_size: int = 0

    # --- pipeline ---
    batch_size: int = 16                 # THE bucket: one capture;
    # partial shard tails pad up to it
    workers: int = 0                     # decode/memcpy threads
    # (0 = cpu count)
    stem_s2d: bool = False               # not ported (raises when set)

    # --- leasing ---
    lease_ttl_s: float = 600.0           # a lease not heartbeaten for
    # this long belonged to a dead host and may be re-leased; must
    # exceed the worst single-batch wall time
    worker_name: str = ""                # lease owner + telemetry file
    # suffix (default: <hostname>-<pid>)
    max_shards: int = 0                  # stop this worker after N
    # shards (0 = run to corpus completion)

    # --- dedup (cache/content) ---
    dedup: bool = False                  # packed source only

    # --- warm start ---
    warmstart_dir: str = ""              # the warm-start store's root
    compile_cache_dir: str = ""          # XLA-only (raises when set)

    # --- the port's own ---
    device: str = "cuda"                 # 'cpu' runs the plain program

    def __post_init__(self):
        # required-field checks live in validate_required(): the two-stage
        # parse constructs an all-defaults instance first
        if int(self.batch_size) < 1:
            raise ValueError(f"--batch-size must be >= 1, got "
                             f"{self.batch_size}")
        if int(self.frames) < 1:
            raise ValueError(f"--frames must be >= 1, got {self.frames}")
        if float(self.lease_ttl_s) <= 0:
            raise ValueError(f"--lease-ttl-s must be > 0, got "
                             f"{self.lease_ttl_s}")
        if int(self.image_size) < 0 or int(self.max_shards) < 0 or \
                int(self.workers) < 0:
            raise ValueError("--image-size / --max-shards / --workers "
                             "must be >= 0")
        if self.stem_s2d:
            raise NotImplementedError(
                "--stem-s2d: the space-to-depth stem is not ported "
                "(ROADMAP Queue 1, item 12)")
        if self.compile_cache_dir:
            raise NotImplementedError(
                "--compile-cache-dir is XLA's persistent compilation "
                "cache; the port compiles no XLA: its warm start (ROADMAP "
                "Queue 1, item 10) is the --warmstart-dir store")
        if self.device not in ("cuda", "cpu") and \
                not str(self.device).startswith("cuda:"):
            raise ValueError(f"--device must be cuda, cuda:N or cpu, got "
                             f"{self.device!r}")

    def validate_required(self) -> "BackfillConfig":
        """The launch-surface checks: what work, where, from which
        source."""
        if not self.manifest:
            raise ValueError("--manifest is required (build one with "
                             "python -m deepfake_detection_tpu_torch."
                             "backfill.manifest)")
        if not self.out:
            raise ValueError("--out is required (the shared run dir)")
        if bool(self.data_packed) == bool(self.data):
            raise ValueError("exactly one of --data-packed / --data "
                             "must be given (the clip source)")
        if self.dedup and not self.data_packed:
            raise ValueError("--dedup needs --data-packed (the dedup "
                             "index hashes pack slabs without decoding)")
        return self

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None
                  ) -> "BackfillConfig":
        return super().from_args(argv).validate_required()


class _LeaseLost(RuntimeError):
    """Our shard lease expired and was legitimately stolen while we
    were stalled: the stealer's books win; ours must stop writing."""


class _Pipeline:
    """The fixed-bucket score program and its staging slots.

    On the card ``graph`` replays the score function captured over the
    static uint8 input ``x`` into the static ``out``; ``launches`` holds
    the kernel launches counted at capture.  On the CPU the function runs
    eagerly at dispatch.  ``free`` holds the host slots no batch holds."""

    #: host slots: two batches in flight, one queued, one being assembled
    SLOTS = 4

    def __init__(self, cfg: BackfillConfig, frames: int,
                 hw: Tuple[int, int]):
        import numpy as np
        import torch

        from ..csrc import build as kernels
        from ..models import create_model, load_checkpoint
        from ..models.factory import resolve_device
        from ..params import img_mean, img_std
        from ..serving.engine import _Slot
        from ..serving.metrics import capture_count
        from ..serving.warmstart import WarmStore

        self.device = resolve_device(cfg.device)   # no card: raises
        self.store = None
        if cfg.warmstart_dir:
            self.store = WarmStore(cfg.warmstart_dir)
            kernels.set_store(self.store)        # before the first kernel
        self.batch = int(cfg.batch_size)
        self.frames = int(frames)
        self.hw = hw
        self.chans = 3 * self.frames
        self.graphs = self.device.type == "cuda"
        if self.graphs:
            # f32 means f32: cuDNN convolutions would otherwise run in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.monotonic()
        model = create_model(cfg.model, num_classes=cfg.num_classes,
                             in_chans=self.chans,
                             img_size=hw[0] if hw[0] == hw[1] else hw,
                             device=self.device)
        if cfg.model_path:
            load_checkpoint(model, cfg.model_path, use_ema=cfg.use_ema)
        else:
            _logger.warning("no --model-path: scoring with a seed-0 random "
                            "init (bench/smoke mode)")
        model.eval()
        self.load_s = time.monotonic() - t0
        # the tiled mean/std as tensors (the JAX runner passes them as
        # arguments so that the division stays a division)
        mean = torch.as_tensor(np.tile(img_mean, self.frames),
                               device=self.device)
        std = torch.as_tensor(np.tile(img_std, self.frames),
                              device=self.device)

        def score(x_u8: torch.Tensor) -> torch.Tensor:
            x = (x_u8.float() - mean) / std
            return torch.softmax(model(x.permute(0, 3, 1, 2)), dim=-1)

        self.fn = score
        shape = (self.batch, hw[0], hw[1], self.chans)
        t0 = time.monotonic()
        captures0 = capture_count()
        self.launches: Dict[str, int] = {}
        self.graph = self.x = self.out = None
        if self.graphs:
            self.stream = torch.cuda.Stream(self.device)
            self.x = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        self._capture()
        self.replays = 0
        self.warm_source, self.warm_fallback = "compile", ""
        if self.store is not None:
            self._warm_store(model, mean, std)
        self.capture_s = time.monotonic() - t0
        self.captures = capture_count() - captures0
        self.slots = [_Slot(shape, torch.uint8, (self.batch, 2), self.device)
                      for _ in range(self.SLOTS)]
        self.free: "queue.Queue" = queue.Queue()
        for s in self.slots:
            self.free.put(s)

    def _capture(self) -> None:
        """Capture the score function (on the CPU: run it once)."""
        import torch

        from ..serving.engine import capture_program

        if not self.graphs:
            with torch.no_grad():
                self.fn(torch.zeros(self.x_shape, dtype=torch.uint8))
            return
        self.graph, self.out, self.launches = capture_program(
            self.fn, self.x, pool=torch.cuda.graph_pool_handle(),
            stream=self.stream, lock=threading.RLock())
        # warm once: the first replay's own first-use work lands before
        # the steady-state capture count is read
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        self.stream.synchronize()

    @property
    def x_shape(self) -> Tuple[int, int, int, int]:
        return (self.batch, self.hw[0], self.hw[1], self.chans)

    def _golden(self):
        """Scores of the fixed seeded canary batch (the serving engine's
        seed) through the program, synchronously."""
        import numpy as np
        import torch

        x = np.random.default_rng(0xCA9A87).integers(
            0, 256, self.x_shape, dtype=np.uint8)
        if not self.graphs:
            with torch.no_grad():
                return self.fn(torch.from_numpy(x)).numpy()
        self.replays += 1
        with torch.cuda.stream(self.stream):
            self.x.copy_(torch.from_numpy(x))
            self.graph.replay()
            out = self.out.cpu()
        return out.numpy()

    def _warm_store(self, model, mean, std) -> None:
        """The store's manifest of this program: the canary on a hit
        (bitwise under the same fingerprint; a skewed one passing is
        re-stamped), a rebuild of the store's libraries and a recapture on
        a reject, a save after a miss, a fallback or a reject."""
        import hashlib

        import numpy as np

        from ..csrc import build as kernels
        from ..serving import warmkey
        from ..serving.engine import _params_fingerprint
        from ..serving.warmstart import WarmstartMiss

        h = hashlib.sha256(repr(model).encode())
        for name, v in sorted(model.state_dict().items()):
            h.update(f"{name}{tuple(v.shape)}{v.dtype}".encode())
        h.update(mean.cpu().numpy().tobytes())
        h.update(std.cpu().numpy().tobytes())
        for digest in kernels.library_digests():
            h.update(digest.encode())
        kind, capability = kernels._device_fields() if self.graphs \
            else ("cpu", "")
        fields = warmkey.key_fields(
            device_kind=kind, capability=capability, program=h.hexdigest(),
            geometry={"hw": list(self.hw), "frames": self.frames,
                      "model_class": type(model).__name__,
                      "pipeline": "backfill"},
            bucket=self.batch, chans=self.chans, wire="uint8", quant="none")
        fingerprint = _params_fingerprint(model.state_dict(), "none")
        try:
            manifest = self.store.load(fields)
        except WarmstartMiss as miss:
            manifest = None
            if miss.reason != "absent":
                self.warm_fallback = miss.reason
                _logger.warning("warm store entry unusable (%s): %s",
                                miss.reason, miss)
        scores = self._golden()
        if manifest is not None:
            why = ""
            if scores.ndim != 2 or scores.shape[0] != self.batch or \
                    not np.isfinite(scores).all():
                why = f"bad golden scores (shape {scores.shape})"
            elif manifest.get("params_fingerprint") == fingerprint:
                ref = warmkey.decode_array(manifest["golden_scores"])
                if ref.shape != scores.shape or \
                        not np.array_equal(ref, scores):
                    why = "golden scores drifted from the manifest"
            if not why:
                self.warm_source = "store"
                if manifest.get("params_fingerprint") != fingerprint:
                    self.store.refresh_manifest(
                        fields, golden_scores=scores,
                        params_fingerprint=fingerprint)
                return
            _logger.error("warm store canary: %s; rebuilding the store's "
                          "libraries and capturing again", why)
            self.warm_fallback = "canary-reject"
            kernels.rebuild_store_libraries()
            self._capture()
            scores = self._golden()
        self.store.save(fields, golden_scores=scores,
                        params_fingerprint=fingerprint)

    def dispatch(self, slot) -> None:
        """Enqueue one batch from ``slot``'s filled input: on the card copy
        in, replay, copy the scores out into the slot and record its
        event, on the pipeline's stream; on the CPU run it now."""
        import torch

        self.replays += 1
        if not self.graphs:
            with torch.no_grad():
                slot.out_np = self.fn(torch.from_numpy(slot.x_np)).numpy()
            return
        with torch.cuda.stream(self.stream):
            self.x.copy_(slot.x, non_blocking=True)
            self.graph.replay()
            slot.out.copy_(self.out, non_blocking=True)
            slot.event.record(self.stream)

    def collect(self, slot):
        """Wait for ``slot``'s scores and copy them; the slot goes back to
        the free list (its input was read before its event)."""
        import numpy as np

        if slot.event is not None:
            slot.event.synchronize()
        scores = np.array(slot.out_np, copy=True)
        self.free.put(slot)
        return scores

    def launch_counts(self) -> Dict[str, int]:
        """Kernel launches of the replays so far: the capture's counts
        times the replays."""
        return {k: n * self.replays for k, n in self.launches.items()}


def _build_dup_map(source, manifest) -> Dict[Tuple[str, int, str], str]:
    """Content-hash pass over the pack: manifest-order duplicate index.

    Hashes every clip's uint8 bytes (``cache/content``'s exact addressing,
    the serving verdict cache's key) straight off the mmap slabs, no
    decode.  The FIRST manifest occurrence of each content hash is
    canonical; every later occurrence maps to its ``kind/root/clip``
    string.  Manifest order is deterministic, so N workers build the
    identical map independently and a relaunched run books the same
    skips.  A clip that fails to load is absent from the index (the score
    path books it ``ok=false`` like any damaged clip)."""
    from ..backfill import manifest_entries
    from ..cache.content import content_hash

    first: Dict[str, Tuple[str, int, str]] = {}
    dup_of: Dict[Tuple[str, int, str], str] = {}
    for entry in manifest_entries(manifest):
        kind, ri, name, _num = entry
        try:
            h = content_hash([source.load(entry)])
        except Exception:                          # noqa: BLE001
            continue
        key = (kind, int(ri), name)
        canon = first.get(h)
        if canon is None:
            first[h] = key
        else:
            dup_of[key] = "/".join(map(str, canon))
    return dup_of


def run_backfill(cfg: BackfillConfig,
                 stop: Optional[threading.Event] = None) -> Dict[str, Any]:
    """One worker's pass over the manifest; returns the run summary
    (books, throughput, captures).  ``stop`` (set by the SIGTERM handler
    or a test) stops at the next batch boundary."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ..backfill import (LeaseDir, ShardVerdictWriter, collect_books,
                            load_manifest, manifest_entries,
                            verify_manifest_source)
    from ..backfill.source import PackSource, TreeSource
    from ..chaos import chaos_from_env
    from ..obs.events import EventLog
    from ..serving.metrics import capture_count

    t_start = time.monotonic()
    cfg.validate_required()
    stop = stop if stop is not None else threading.Event()
    chaos = chaos_from_env()
    if chaos.active:
        _logger.warning("DFD_CHAOS active: %s", sorted(chaos.points))

    manifest = load_manifest(cfg.manifest)
    if cfg.data_packed:
        verify_manifest_source(manifest, pack_dir=cfg.data_packed)
        source: Any = PackSource(cfg.data_packed)
    else:
        verify_manifest_source(manifest, roots=cfg.data)
        source = TreeSource(cfg.data, frames_per_clip=cfg.frames,
                            image_size=cfg.image_size)
    frames = source.frames_per_clip
    dup_of: Dict[Tuple[str, int, str], str] = {}
    dedup_s = 0.0
    if cfg.dedup:
        t_h = time.monotonic()
        dup_of = _build_dup_map(source, manifest)
        dedup_s = time.monotonic() - t_h
        _logger.info(
            "dedup index: hashed %d clips in %.1fs — %d duplicate(s) "
            "will skip the device and book skipped_dup",
            manifest["num_clips"], dedup_s, len(dup_of))
    run_dir = cfg.out
    os.makedirs(run_dir, exist_ok=True)
    owner = cfg.worker_name or f"{socket.gethostname()}-{os.getpid()}"
    lease = LeaseDir(run_dir, owner, ttl_s=cfg.lease_ttl_s)
    # one telemetry stream PER WORKER: N processes share the run dir, and
    # EventLog's open-time torn-tail repair must never truncate a live
    # peer's in-flight write (tools/obs_report.py merges them)
    log = EventLog(os.path.join(run_dir, f"telemetry-{owner}.jsonl"))

    pending = lease.pending_shards(manifest)
    summary: Dict[str, Any] = {
        "worker": owner, "shards_this_proc": 0, "clips_this_proc": 0,
        "failed_this_proc": 0, "skipped_dup_this_proc": 0,
        "lease_lost": 0, "lease_steals": 0,
        "steady_recompiles": 0, "clips_per_s": 0.0, "elapsed_s": 0.0,
        "captures": 0, "capture_s": 0.0, "load_s": 0.0,
        "dedup_s": round(dedup_s, 3), "ready_s": 0.0, "launches": {},
        "replays": 0, "warmstart_source": "", "warmstart_fallback": "",
    }
    pipe: Optional[_Pipeline] = None
    if pending:
        if source.sample_hw is None:
            # raw tree with no --image-size: the first LOADABLE clip
            # fixes the bucket geometry (every later clip must match,
            # loudly); a corrupt first clip is booked like any other
            probe_err: Optional[Exception] = None
            for entry in manifest_entries(manifest):
                try:
                    source.load(entry)
                    break
                except Exception as e:             # noqa: BLE001
                    probe_err = e
            if source.sample_hw is None:
                raise RuntimeError(
                    f"no clip in the manifest could be decoded to fix "
                    f"the batch geometry (last error: {probe_err}) — "
                    f"set --image-size explicitly or repair the corpus")
        pipe = _Pipeline(cfg, frames, source.sample_hw)
        summary.update(captures=pipe.captures,
                       capture_s=round(pipe.capture_s, 3),
                       load_s=round(pipe.load_s, 3),
                       warmstart_source=pipe.warm_source
                       if pipe.store is not None else "",
                       warmstart_fallback=pipe.warm_fallback)
        _logger.info(
            "bucket %s in %.1fs: batch %d × %dx%d × %dch on %s; %d/%d "
            "shards pending", "captured" if pipe.graphs else "ready "
            "(eager, CPU)", pipe.capture_s, pipe.batch,
            source.sample_hw[1], source.sample_hw[0], pipe.chans,
            pipe.device, len(pending), len(manifest["shards"]))
    log.event("run_start", mode="backfill", manifest=cfg.manifest,
              fingerprint=manifest["fingerprint"],
              num_clips=manifest["num_clips"],
              shards_total=len(manifest["shards"]),
              shards_pending=len(pending), worker=owner,
              batch_size=cfg.batch_size,
              device=str(pipe.device) if pipe else None)

    pool = ThreadPoolExecutor(max(1, int(cfg.workers or 0)
                                  or (os.cpu_count() or 4)))
    batch_seq = 0         # device-batch counter (the chaos step)
    acquire_seq = 0       # lease-attempt counter (lease_race chaos step)
    captures_steady0 = capture_count()
    t_first: Optional[float] = None
    t_last = time.monotonic()

    def _safe_load(entry):
        try:
            return entry, source.load(entry), ""
        except Exception as e:                     # noqa: BLE001
            # a single unreadable clip must cost ONE failed book entry,
            # never the shard (the corpus is archival; damage happens)
            return entry, None, f"{type(e).__name__}: {e}"

    def _process_shard(sid: str) -> bool:
        """Score one leased shard; True iff committed."""
        nonlocal batch_seq, t_first, t_last
        t0 = time.monotonic()
        writer = ShardVerdictWriter(run_dir, sid)
        entries = list(manifest_entries(manifest, sid))
        todo = [e for e in entries
                if (e[0], e[1], e[2]) not in writer.scored_keys]
        resumed = len(entries) - len(todo)
        failed0 = writer.failed       # inherited from a predecessor's
        # surviving records — not this process's doing
        skipped0 = writer.skipped
        if dup_of:
            # book the shard's duplicates up front, before any batch
            # dispatches: the skip rows land in one write, and a kill
            # right after still resumes exactly (scored_keys covers them)
            dups = [e for e in todo if (e[0], e[1], e[2]) in dup_of]
            if dups:
                writer.append_dups(
                    [(kind, ri, name, 0 if kind == "fake" else 1,
                      dup_of[(kind, ri, name)])
                     for kind, ri, name, _num in dups])
                todo = [e for e in todo
                        if (e[0], e[1], e[2]) not in dup_of]
        if resumed:
            _logger.info("%s: resuming a partial shard — %d/%d verdicts "
                         "survive (%d torn bytes dropped)", sid, resumed,
                         len(entries), writer.torn_bytes_dropped)
        B = pipe.batch
        hw, chans = pipe.hw, pipe.chans
        data_wait = device_wait = host_s = 0.0

        q: "queue.Queue" = queue.Queue(maxsize=2)
        shard_stop = threading.Event()     # abandons the producer when
        # the consumer bails early (lost lease, SIGTERM)

        def _halted() -> bool:
            return stop.is_set() or shard_stop.is_set()

        def _put(item) -> bool:
            while not _halted():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _free_slot():
            while not _halted():
                try:
                    return pipe.free.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        # thread fan-out only pays when a clip is real work (a decode, or
        # a memcpy big enough to release the GIL meaningfully); for small
        # packed clips the per-task scheduling costs more than the read
        clip_nbytes = hw[0] * hw[1] * chans
        fan_out = not getattr(source, "zero_decode", False) or \
            clip_nbytes >= (1 << 18)

        def produce():
            for ci in range(0, len(todo), B):
                if _halted():
                    return
                chunk = todo[ci:ci + B]
                loaded = list(pool.map(_safe_load, chunk)) if fan_out \
                    else [_safe_load(e) for e in chunk]
                ok = [(e, a) for e, a, _err in loaded if a is not None]
                fails = [(e, err) for e, a, err in loaded if a is None]
                slot = None
                if ok:
                    # the slab is assembled in a pinned slot whose last
                    # batch has completed (its event): never under a
                    # copy still reading it
                    slot = _free_slot()
                    if slot is None:
                        return
                    for j, (_e, a) in enumerate(ok):
                        slot.x_np[j] = a          # the slab memcpy
                    slot.x_np[len(ok):] = 0
                if not _put(([e for e, _ in ok], slot, fails)):
                    if slot is not None:
                        pipe.free.put(slot)
                    return
            _put(None)

        producer = threading.Thread(target=produce, daemon=True,
                                    name=f"backfill-produce-{sid}")
        producer.start()

        #: heartbeat/ownership cadence: frequent enough that a live
        #: worker's lease mtime is always far younger than the TTL
        beat_every = min(1.0, cfg.lease_ttl_s / 10.0)
        last_beat = 0.0

        def _beat(now: float) -> None:
            """Heartbeat + ownership on the time cadence.  Runs before
            EVERY write (and in the main loop), so no stall can exceed
            ``beat_every`` between an ownership confirmation and an
            append: a TTL-starved worker abandons instead of appending
            duplicates of clips the stealer is re-scoring."""
            nonlocal last_beat
            if now - last_beat >= beat_every:
                last_beat = now
                lease.heartbeat(sid)
                if not lease.still_owner(sid):
                    raise _LeaseLost(sid)

        def _complete(staged) -> None:
            nonlocal device_wait, host_s
            ok_entries, fails, slot, seq = staged
            t_dev = time.monotonic()
            scores = pipe.collect(slot) if slot is not None else None
            device_wait += time.monotonic() - t_dev
            _beat(time.monotonic())       # BEFORE the append, always
            t_host = time.monotonic()
            rows = []
            for j, (kind, ri, name, _num) in enumerate(ok_entries):
                s = float(scores[j, 0])                 # P(fake)
                if np.isfinite(s):
                    rows.append((kind, ri, name,
                                 0 if kind == "fake" else 1, s, ""))
                else:
                    # a non-finite score is NEVER served (the serving
                    # engine's contract): book the clip failed
                    rows.append((kind, ri, name,
                                 0 if kind == "fake" else 1, None,
                                 "NonFiniteScore: model produced a "
                                 "non-finite probability"))
            rows += [(kind, ri, name, 0 if kind == "fake" else 1,
                      None, err)
                     for (kind, ri, name, _num), err in fails]
            writer.append_many(rows)
            host_s += time.monotonic() - t_host
            if chaos.active and chaos.fires("backfill_torn_shard", seq):
                # tear the stream exactly as a mid-write kill would:
                # half a record, no newline, then a hard death that
                # leaves the lease behind (a dead host, not a SIGTERM)
                writer.tear()
                _logger.error("chaos: torn shard %s at batch %d; hard "
                              "exit", sid, seq)
                os._exit(int(chaos.arg("backfill_torn_shard", 137)))

        #: dispatched-but-uncompleted batches, oldest first: batch k+1's
        #: copy in and replay queue behind batch k's on the stream while
        #: the host books k-1's verdicts
        inflight: List[Tuple] = []
        committed = False
        lost = False
        try:
            while True:
                t_q = time.monotonic()
                item = None
                while not stop.is_set():
                    try:
                        item = q.get(timeout=0.1)
                        break
                    except queue.Empty:
                        # a data-side stall must not let a LIVE worker's
                        # lease age into stealable: keep beating
                        _beat(time.monotonic())
                        continue
                data_wait += time.monotonic() - t_q
                if item is None:          # end of shard, or SIGTERM
                    break
                ok_entries, slot, fails = item
                seq = batch_seq
                batch_seq += 1
                if chaos.active and chaos.fires("backfill_kill", seq):
                    # a preemption mid-corpus: a REAL SIGTERM, so the
                    # production handler (stop at the batch boundary,
                    # release leases, exit 75) is what gets exercised
                    _logger.error("chaos: SIGTERM to self at batch %d",
                                  seq)
                    os.kill(os.getpid(), signal.SIGTERM)
                if slot is not None:
                    pipe.dispatch(slot)
                if t_first is None:
                    t_first = time.monotonic()
                inflight.append((ok_entries, fails, slot, seq))
                if len(inflight) > 2:
                    _complete(inflight.pop(0))
                _beat(time.monotonic())
            while inflight and not lost:
                _complete(inflight.pop(0))
            t_last = time.monotonic()
            need = {(e[0], e[1], e[2]) for e in entries}
            if not lost and not stop.is_set() and \
                    need <= writer.scored_keys:
                # every manifest clip of this shard has a record (set
                # containment, not a count — an alien record must never
                # mask a missing clip): commit
                book = writer.finalize()
                committed = lease.mark_done(sid, book)
        except _LeaseLost:
            # TTL-starved: another worker legitimately stole the shard —
            # its books win; ours stop here, uncommitted
            _logger.error("%s: lease lost mid-shard (TTL %.0fs too short "
                          "for this batch cadence?); abandoning",
                          sid, cfg.lease_ttl_s)
            summary["lease_lost"] += 1
            lost = True
            t_last = time.monotonic()
        finally:
            shard_stop.set()
            producer.join(timeout=30.0)
            # every slot back to the free list: the ones in flight once
            # their event has passed, the assembled ones unread
            for _e, _f, slot, _s in inflight:
                if slot is not None:
                    pipe.collect(slot)
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and item[1] is not None:
                    pipe.free.put(item[1])
            writer.close()
            if not committed:
                lease.release(sid)
        wall = time.monotonic() - t0
        done_clips = writer.records - resumed
        log.metrics(
            shard=sid, clips=len(entries), scored=writer.records -
            writer.failed - writer.skipped, failed=writer.failed,
            skipped_dup=writer.skipped, resumed=resumed,
            committed=committed, wall_s=round(wall, 3),
            clips_per_s=round(done_clips / wall, 2) if wall else None,
            data_wait_s=round(data_wait, 3),
            device_wait_s=round(device_wait, 3),
            host_s=round(host_s, 3),
            backend_compiles=capture_count() - captures_steady0,
            torn_bytes_dropped=writer.torn_bytes_dropped,
            worker=owner)
        summary["clips_this_proc"] += done_clips
        summary["failed_this_proc"] += writer.failed - failed0
        summary["skipped_dup_this_proc"] += writer.skipped - skipped0
        return committed

    rival = None
    try:
        while not stop.is_set():
            pending = lease.pending_shards(manifest)
            if not pending:
                break
            if cfg.max_shards and \
                    summary["shards_this_proc"] >= cfg.max_shards:
                break
            progressed = False
            for sid in pending:
                if stop.is_set():
                    break
                if cfg.max_shards and \
                        summary["shards_this_proc"] >= cfg.max_shards:
                    break
                if chaos.active and \
                        chaos.fires("backfill_lease_race", acquire_seq):
                    # a rival worker wins the race for THIS shard an
                    # instant before us: our acquire must lose cleanly
                    # and move on; the rival's lease then expires by TTL
                    # and the stale-break path re-leases it
                    if rival is None:
                        rival = LeaseDir(run_dir, "chaos-rival",
                                         ttl_s=cfg.lease_ttl_s)
                    rival.acquire(sid)
                    _logger.error("chaos: rival leased %s ahead of us",
                                  sid)
                acquire_seq += 1
                if not lease.acquire(sid):
                    continue
                if lease.last_steal is not None:
                    summary["lease_steals"] += 1
                    log.event("lease_steal", shard=sid,
                              prev_owner=lease.last_steal.get("owner"))
                    lease.last_steal = None
                if _process_shard(sid):
                    summary["shards_this_proc"] += 1
                    progressed = True
            if not progressed and not stop.is_set() and \
                    lease.pending_shards(manifest):
                # everything left is leased elsewhere (or freshly
                # rivaled): wait out a fraction of the TTL and re-sweep.
                # Sleep, not ``stop.wait``: ``main``'s signal handler sets
                # ``stop`` in this thread, and a signal landing while
                # ``wait`` holds the event's lock would deadlock
                time.sleep(min(1.0, cfg.lease_ttl_s / 4.0))
    finally:
        pool.shutdown(wait=False)

    summary["steady_recompiles"] = capture_count() - captures_steady0
    if pipe is not None:
        summary["launches"] = pipe.launch_counts()
        summary["replays"] = pipe.replays
        if pipe.store is not None:
            from ..csrc.build import library_counts
            summary["warmstart_kernels"] = library_counts()
    if t_first is not None:
        # cold start: entry to the first batch dispatched (manifest, source
        # audit, dedup pass, model load, capture)
        summary["ready_s"] = round(t_first - t_start, 3)
        summary["elapsed_s"] = round(t_last - t_first, 3)
        if summary["elapsed_s"] > 0:
            summary["clips_per_s"] = round(
                summary["clips_this_proc"] / summary["elapsed_s"], 2)
    books = collect_books(run_dir, manifest)
    summary["books"] = books
    summary["preempted"] = stop.is_set()
    log.event("run_end", **{k: v for k, v in summary.items()})
    log.close()
    if summary["steady_recompiles"]:
        _logger.error("%d CUDA graph capture(s) AFTER the bucket warmup — "
                      "the one-capture contract broke",
                      summary["steady_recompiles"])
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    cfg = BackfillConfig.from_args(argv)

    stop = threading.Event()

    def _sig(signum, frame):
        _logger.info("signal %d: stopping at the next batch boundary",
                     signum)
        stop.set()

    old = {s: signal.signal(s, _sig) for s in (signal.SIGTERM,
                                                signal.SIGINT)}
    try:
        summary = run_backfill(cfg, stop=stop)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    books = summary["books"]
    _logger.info(
        "worker %s: %d shard(s), %d clip(s) this process at %.1f "
        "clips/s; corpus %d/%d shards done — books: %d manifest == %d "
        "scored + %d failed + %d skipped_dup (%s)", summary["worker"],
        summary["shards_this_proc"], summary["clips_this_proc"],
        summary["clips_per_s"], books["shards_done"],
        books["shards_total"], books["manifest_clips"], books["scored"],
        books["failed"], books["skipped_dup"],
        "BALANCED" if books["balanced"] else
        ("incomplete" if not books["complete"] else "IMBALANCED"))
    if summary["preempted"]:
        return EXIT_PREEMPTED
    if books["complete"] and not books["balanced"]:
        _logger.error("books do not balance: missing=%s duplicated=%s "
                      "alien=%s", books["missing"][:5],
                      books["duplicated"][:5], books["alien"][:5])
        return 1
    if summary["steady_recompiles"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
