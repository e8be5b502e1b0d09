"""Knob surfaces of the serving replica (:class:`ServeConfig`) and of the
streaming server built on it (:class:`StreamConfig`).

The counterpart of ``ServeConfig`` and ``parse_model_spec`` in
``deepfake_detection_tpu/config.py``: the same fields, defaults and checks,
every field a ``--dashed-flag`` (a ``-c`` YAML or JSON file resets the
defaults, the command line overrides them), plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch programs, for the tests).

``--dtype`` and a ``--models`` entry's ``dtype`` take f32, bf16 or int8
(aliases float32, bfloat16): the weight-only PTQ of ``serving/quant.py``.
``--warmstart-dir`` attaches the warm-start store of
``serving/warmstart.py`` (the built kernel libraries and the capture
manifests with their golden-batch scores; a CUDA graph itself cannot be
serialized).  The XLA-only ``--compile-cache-dir`` and
``--single-thread-xla`` parse and raise ``NotImplementedError`` when set,
and so does ``--warm-parallel`` above 1: the captures of one engine share
one memory pool and run one at a time.
:class:`StreamConfig` inherits all of this, as the JAX one inherits
``ServeConfig`` (``deepfake_detection_tpu/config.py``).
:class:`RouterConfig` is the fleet router's (``runners/router.py``), whose
process imports no torch: this module is standard library only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["FlagConfig", "RouterConfig", "ServeConfig", "StreamConfig",
           "parse_model_spec"]

#: serving PTQ dtypes (canonical + accepted aliases), as the JAX config
_QUANT_DTYPES = {"f32": "f32", "float32": "f32",
                 "bf16": "bf16", "bfloat16": "bf16", "int8": "int8"}


def _canon_quant_dtype(s: str, flag: str) -> str:
    try:
        return _QUANT_DTYPES[str(s).lower()]
    except KeyError:
        raise ValueError(f"{flag} must be one of f32|bf16|int8 (aliases "
                         f"float32, bfloat16), got {s!r}") from None


def _tuple_of_ints(s) -> Optional[Tuple[int, ...]]:
    if s is None or s == "":
        return None
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).split(","))


def parse_model_spec(spec: str, *, default_size: int,
                     default_img_num: int) -> Dict[str, Any]:
    """One ``--models`` entry → spec dict.

    Grammar: ``id=family[,path=CKPT][,size=N][,img_num=K][,dtype=D]
    [,reload=DIR]`` — the first token names the table id and the model
    family; the rest override the primary model's geometry/dtype
    defaults.  Example::

        student=efficientnet_deepfake_v4,size=300
    """
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts or "=" not in parts[0]:
        raise ValueError(f"--models entry {spec!r} must start with "
                         f"id=family")
    model_id, family = parts[0].split("=", 1)
    out: Dict[str, Any] = {"id": model_id.strip(),
                           "family": family.strip(), "path": "",
                           "size": int(default_size),
                           "img_num": int(default_img_num),
                           "dtype": "f32", "reload": ""}
    if not out["id"] or not out["family"]:
        raise ValueError(f"--models entry {spec!r}: empty id or family")
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(f"--models entry {spec!r}: {part!r} is not "
                             f"key=value")
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        if k == "path" or k == "reload":
            out[k] = v
        elif k == "size" or k == "img_num":
            out[k] = int(v)
            if out[k] < 1:
                raise ValueError(f"--models entry {spec!r}: {k} must be "
                                 f">= 1")
        elif k == "dtype":
            out[k] = _canon_quant_dtype(v, f"--models {out['id']} dtype")
        else:
            raise ValueError(f"--models entry {spec!r}: unknown key "
                             f"{k!r} (path|size|img_num|dtype|reload)")
    return out


class FlagConfig:
    """Flag surface shared by the runners' config dataclasses: every field
    a ``--dashed-flag`` (bools as ``store_true``), a ``-c`` YAML (or JSON)
    file resetting the defaults and the command line overriding them;
    unknown flags are an error."""

    #: the argument parser's description
    DESCRIPTION = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        known = {f_.name for f_ in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str):
        """A YAML file where PyYAML is installed, else JSON."""
        with open(path) as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            d = json.loads(text)
        else:
            d = yaml.safe_load(text)
        return cls.from_dict(d or {})

    @classmethod
    def argument_parser(cls) -> argparse.ArgumentParser:
        """One flag per field (dashes), bools as store_true."""
        p = argparse.ArgumentParser(description=cls.DESCRIPTION)
        p.add_argument("-c", "--config", default="", metavar="FILE",
                       help="YAML (or JSON) config; its values reset "
                            "defaults, CLI overrides")
        for f_ in fields(cls):
            flag = "--" + f_.name.replace("_", "-")
            if isinstance(f_.default, bool):
                p.add_argument(flag, action="store_true", default=None,
                               dest=f_.name)
            else:
                p.add_argument(flag, default=None, dest=f_.name)
        return p

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None):
        """Two-stage parse: the config file resets defaults, the command
        line overrides; unknown flags are an error."""
        ns = cls.argument_parser().parse_args(argv)
        base = cls.from_yaml(ns.config) if ns.config else cls()
        out = dataclasses.asdict(base)
        by_name = {f_.name: f_ for f_ in fields(cls)}
        for k, v in vars(ns).items():
            if k == "config" or v is None:
                continue
            default = by_name[k].default
            if isinstance(default, bool):
                out[k] = bool(v)
            elif isinstance(default, tuple):
                out[k] = _tuple_of_ints(v)
            elif isinstance(default, float):
                out[k] = float(v)
            elif isinstance(default, int):
                out[k] = int(v)
            else:
                out[k] = v
        return cls.from_dict(out)


@dataclass
class ServeConfig(FlagConfig):
    """Knob surface of the dynamic-batching inference server.

    The batch **buckets** are the program table: one program per (model,
    bucket, channel width), each captured as a CUDA graph before the
    server reports ready, and every device call pads to one of them.
    The comments are the JAX config's, where they still hold.
    """
    DESCRIPTION = ("dynamic-batching deepfake-detection inference server "
                   "(PyTorch, CUDA graphs)")

    # --- network ---
    host: str = "127.0.0.1"
    port: int = 8377

    # --- model (mirrors runners/test.py) ---
    model: str = "efficientnet_deepfake_v4"
    model_path: str = ""                 # torch file (timm keys); empty
    # serves the seeded init (bench/demo, like test.py)
    use_ema: bool = False                # prefer the EMA stream on load
    image_size: int = 600                # canvas side (params.py flagship 600)
    img_num: int = 4                     # frame replication => in_chans 3*num
    num_classes: int = 2

    # host→device wire format: 'float32' ships the fully CLI-preprocessed
    # tensor; 'uint8' ships the uint8 canvas and normalizes/replicates
    # inside the captured program (4·img_num× less transfer)
    wire: str = "float32"
    # multi-frame clips on the uint8 wire need a SECOND program per bucket
    # (≈2× warmup); a deployment that only ever scores single frames can
    # opt out (a no-op on the float32 wire)
    single_frame_only: bool = False

    # --- post-training quantization (serving/quant.py) ---
    # weight-only PTQ of the served copy: 'f32' (CLI-exact parity),
    # 'bf16' (params cast) or 'int8' (per-output-channel symmetric conv/
    # linear kernels, dequantized inside each captured program); the
    # checkpoint on disk and the reload path stay f32
    dtype: str = "f32"

    # --- multi-model serving ---
    # extra model-table entries, ';'-separated specs:
    #   id=family[,path=CKPT][,size=N][,img_num=K][,dtype=D][,reload=DIR]
    models: str = ""

    # --- two-tier cascade (serving/cascade.py) ---
    cascade: str = ""
    cascade_low: float = 0.2
    cascade_high: float = 0.8

    # --- micro-batching / program table ---
    buckets: Tuple[int, ...] = (1, 4, 16, 64)
    batch_deadline_ms: float = 5.0       # partial-batch flush window
    max_queue: int = 128                 # load-shed (429) past this depth
    request_timeout_ms: float = 2000.0   # per-request deadline (504)

    # --- hot weight reload ---
    reload_dir: str = ""                 # "" disables the watcher
    reload_interval_s: float = 5.0
    # golden-batch canary score-drift tolerance (< 0 disables the gate;
    # finiteness + shape always gate)
    reload_drift_tol: float = -1.0

    # --- resilience (serving/resilience.py) ---
    watchdog_timeout_s: float = 30.0     # 0 disables
    breaker_threshold: int = 5           # 0 disables
    breaker_open_s: float = 5.0
    retry_jitter_s: float = 2.0

    # --- verdict cache (cache/) ---
    cache_entries: int = 0               # 0 disables the tier
    cache_ttl_s: float = 300.0
    cache_near_dup: bool = False
    cache_near_radius: int = 3

    # --- observability ---
    throughput_window_s: float = 30.0

    # --- XLA-only (raise when set) ---
    single_thread_xla: bool = False

    # --- warm start ---
    warmstart_dir: str = ""              # the warm-start store's root
    compile_cache_dir: str = ""          # XLA-only (raises when set)
    # staged readiness: capture the first priority bucket, report /readyz
    # 200 in phase "degraded", capture the rest in the background
    warm_staged: bool = False
    # comma-separated bucket warm order ("" = smallest-first); must be a
    # subset of --buckets
    warm_priority: str = ""
    # 0 = auto, 1 = serial: captures are serial either way
    warm_parallel: int = 0

    # --- the port's own ---
    device: str = "cuda"                 # 'cpu' runs the plain programs

    # ------------------------------------------------------------------
    def warm_priority_buckets(self) -> Tuple[int, ...]:
        s = str(self.warm_priority).strip()
        return _tuple_of_ints(s) if s else ()

    def __post_init__(self):
        if isinstance(self.buckets, str):
            self.buckets = _tuple_of_ints(self.buckets)
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"--buckets must be positive ints, got "
                             f"{self.buckets}")
        if self.batch_deadline_ms < 0:
            raise ValueError("--batch-deadline-ms must be >= 0")
        if self.max_queue < self.buckets[-1]:
            raise ValueError(
                f"--max-queue ({self.max_queue}) below the largest bucket "
                f"({self.buckets[-1]}) could never fill a full batch")
        if self.img_num < 1:
            raise ValueError("--img-num must be >= 1")
        if self.wire not in ("float32", "uint8"):
            raise ValueError(f"--wire must be float32|uint8, "
                             f"got {self.wire!r}")
        if self.watchdog_timeout_s < 0 or self.retry_jitter_s < 0:
            raise ValueError("--watchdog-timeout-s / --retry-jitter-s "
                             "must be >= 0")
        if self.breaker_threshold < 0:
            raise ValueError("--breaker-threshold must be >= 0 (0 = off)")
        if self.breaker_open_s <= 0:
            raise ValueError("--breaker-open-s must be > 0")
        if int(self.cache_entries) < 0:
            raise ValueError(f"--cache-entries must be >= 0 (0 = off), "
                             f"got {self.cache_entries}")
        if float(self.cache_ttl_s) <= 0:
            raise ValueError(f"--cache-ttl-s must be > 0, got "
                             f"{self.cache_ttl_s}")
        if not 0 <= int(self.cache_near_radius) <= 8:
            raise ValueError(f"--cache-near-radius must be in [0, 8], "
                             f"got {self.cache_near_radius}")
        if int(self.warm_parallel) < 0:
            raise ValueError("--warm-parallel must be >= 0 (0 = auto)")
        if int(self.warm_parallel) > 1:
            raise NotImplementedError(
                f"--warm-parallel {self.warm_parallel}: the captures of one "
                "engine share one memory pool and run one at a time")
        bad = [b for b in self.warm_priority_buckets()
               if b not in self.buckets]
        if bad:
            raise ValueError(f"--warm-priority buckets {bad} not in "
                             f"--buckets {self.buckets}")
        if self.compile_cache_dir:
            raise NotImplementedError(
                "--compile-cache-dir is XLA's persistent compilation cache; "
                "the port compiles no XLA: its warm start (ROADMAP Queue 1, "
                "item 10) is the --warmstart-dir store")
        if self.single_thread_xla:
            raise NotImplementedError(
                "--single-thread-xla caps XLA's CPU backend, which the port "
                "does not run (ROADMAP Queue 1, item 10)")
        if self.device not in ("cuda", "cpu") and \
                not str(self.device).startswith("cuda:"):
            raise ValueError(f"--device must be cuda, cuda:N or cpu, got "
                             f"{self.device!r}")
        self.dtype = _canon_quant_dtype(self.dtype, "--dtype")
        specs = self.model_specs()          # validates the grammar
        ids = [s["id"] for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"--models ids must be unique, got {ids}")
        if self.model in ids:
            raise ValueError(f"--models id {self.model!r} collides with "
                             f"the primary --model")
        if not 0.0 <= float(self.cascade_low) <= \
                float(self.cascade_high) <= 1.0:
            raise ValueError(
                f"--cascade-low/--cascade-high must satisfy 0 <= low <= "
                f"high <= 1, got [{self.cascade_low}, "
                f"{self.cascade_high}]")
        if self.cascade:
            by_id = {s["id"]: s for s in specs}
            if self.cascade not in by_id:
                raise ValueError(
                    f"--cascade {self.cascade!r} must name a --models "
                    f"entry (got {sorted(by_id) or 'none'})")
            if by_id[self.cascade]["img_num"] != self.img_num:
                raise ValueError(
                    f"--cascade student img_num "
                    f"{by_id[self.cascade]['img_num']} != flagship "
                    f"img_num {self.img_num}: the same clips must flow "
                    f"through both tiers")

    def model_specs(self) -> List[Dict[str, Any]]:
        """Parsed ``--models`` entries (see :func:`parse_model_spec`)."""
        return [parse_model_spec(s, default_size=self.image_size,
                                 default_img_num=self.img_num)
                for s in str(self.models).split(";") if s.strip()]

    @property
    def max_batch_size(self) -> int:
        return self.buckets[-1]

    @property
    def in_chans(self) -> int:
        return 3 * self.img_num


@dataclass
class StreamConfig(ServeConfig):
    """Knob surface of the streaming-video scoring server
    (``runners/stream.py``).

    Extends :class:`ServeConfig` (the engine/batcher knobs are the same
    machinery) with the stream-pipeline stages: face localization +
    tracking, temporal windowing, per-stream verdict hysteresis, and
    session lifecycle.  The JAX ``StreamConfig``'s fields, defaults and
    checks; every field a ``--dashed-flag``.
    """
    DESCRIPTION = ("streaming-video deepfake-detection scoring server "
                   "(PyTorch, CUDA graphs)")

    port: int = 8378                     # one above the serving default

    # --- face localization + tracking (streaming/tracker.py) ---
    # 'full_frame' (deterministic built-in, pre-cropped parity) or
    # 'callable:<module>:<attr>' plugging in a model-backed detector
    localizer: str = "full_frame"
    track_iou_min: float = 0.3           # greedy-IoU association floor
    track_ema_alpha: float = 0.6         # box smoothing (1.0 = raw boxes)
    track_max_coast: int = 10            # missed frames before track death
    track_min_hits: int = 1              # detections before a track scores
    crop_margin: float = 0.15            # face-box expansion before crop

    # --- temporal windowing (streaming/windows.py) ---
    window_stride: int = 1               # in-window frame spacing
    window_hop: int = 0                  # pushes between windows (0 = tile:
    # img_num*stride, non-overlapping)
    max_inflight_windows: int = 4        # per-stream bound; beyond it the
    # OLDEST pending window is dropped (drop-oldest backpressure)

    # --- host fast path (streaming/ring.py) ---
    # 'ring' = frame-once lifecycle: per-track preallocated crop rings,
    # one prepare_canvas + one sha256 per crop, zero-copy FrameStack
    # window payloads gathered straight into the engine's batch slot.
    # 'concat' = the standalone-canvas + np.concatenate path (parity and
    # bench reference)
    assembly: str = "ring"
    # consecutive-duplicate elision (frozen/low-motion streams): frames
    # whose encoded bytes match their predecessor skip decode, and a
    # window whose clip content equals the track's previous window skips
    # submission — both counted (frames_dup_elided / windows_dup_elided),
    # never silent.  Off by default
    dedup_frames: bool = False

    # --- verdict hysteresis (streaming/verdict.py) ---
    verdict_ema_alpha: float = 0.3       # EMA over window scores
    suspect_enter: float = 0.5
    suspect_exit: float = 0.35
    fake_enter: float = 0.8
    fake_exit: float = 0.65
    verdict_min_windows: int = 1         # EMA warmup before verdicts move

    # --- session lifecycle (streaming/ingest.py) ---
    max_streams: int = 64
    stream_ttl_s: float = 120.0          # idle eviction (0 = never)
    event_log_dir: str = ""              # per-stream verdict-event JSONL
    # session durability: snapshot per-stream tracker + verdict-machine +
    # window-position state here on shutdown/SIGTERM and restore on the
    # next start, so a server bounce RESUMES verdict streams ("" disables)
    state_dir: str = ""

    # --- bench/test instrumentation ---
    # planted per-window scores ("0.05*8,0.95*12"): windows still ride the
    # engine (load/latency are real) but the VERDICT machines consume the
    # planted sequence, so transition tests are deterministic
    verdict_vector: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        super().__post_init__()
        from ..streaming.verdict import VerdictThresholds
        VerdictThresholds(self.suspect_enter, self.suspect_exit,
                          self.fake_enter, self.fake_exit)  # validates
        if not 0.0 < self.verdict_ema_alpha <= 1.0:
            raise ValueError(f"--verdict-ema-alpha must be in (0, 1], got "
                             f"{self.verdict_ema_alpha}")
        if not 0.0 < self.track_ema_alpha <= 1.0:
            raise ValueError(f"--track-ema-alpha must be in (0, 1], got "
                             f"{self.track_ema_alpha}")
        if not 0.0 <= self.track_iou_min <= 1.0:
            raise ValueError(f"--track-iou-min must be in [0, 1], got "
                             f"{self.track_iou_min}")
        for name in ("window_stride", "max_inflight_windows", "max_streams",
                     "verdict_min_windows", "track_min_hits"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"--{name.replace('_', '-')} must be "
                                 f">= 1, got {getattr(self, name)}")
        if int(self.window_hop) < 0 or int(self.track_max_coast) < 0 or \
                float(self.crop_margin) < 0 or float(self.stream_ttl_s) < 0:
            raise ValueError("window-hop / track-max-coast / crop-margin / "
                             "stream-ttl-s must be >= 0")
        if self.assembly not in ("ring", "concat"):
            raise ValueError(f"--assembly must be 'ring' or 'concat', "
                             f"got {self.assembly!r}")


@dataclass
class RouterConfig(FlagConfig):
    """Knob surface of the fleet replica router.

    Same conventions as the other configs: every field is a
    ``--dashed-flag``, a YAML ``-c`` file resets defaults, CLI
    overrides.  The router attaches to running replicas
    (``--replicas url,url``) and/or spawns its own local fleet
    (``--spawn N`` children of ``--spawn-runner`` with
    ``--replica-args`` passed through) — both sets join one registry.

    The counterpart of the JAX ``RouterConfig``: every field, default and
    check.  No ``--device``: the router holds no device and imports no
    torch; spawned replicas take theirs through ``--replica-args`` (the
    port's runners default to ``cuda``).
    """

    DESCRIPTION = "fleet replica router (shared-nothing scale-out)"
    # --- network ---
    host: str = "127.0.0.1"
    port: int = 8380                     # serve=8377, stream=8378

    # --- fleet membership ---
    replicas: str = ""                   # comma list of replica URLs
    # (host:port or http://host:port) to attach to
    spawn: int = 0                       # local replica children to spawn
    spawn_runner: str = "serve"          # serve | stream
    replica_args: str = ""               # extra CLI for every spawned
    # replica (shlex-split), e.g. "--model-path m.pth --device cuda"

    # --- health (fleet/controller.py scraper) ---
    scrape_interval_s: float = 0.5
    health_fail_after: int = 3           # consecutive scrape failures
    # before a replica is marked down
    scrape_timeout_s: float = 2.0

    # --- routing (fleet/router.py) ---
    virtual_nodes: int = 64              # hash-ring vnodes per replica
    route_retries: int = 2               # failover attempts past the
    # first replica on shed/transport error (stateless traffic only)
    upstream_timeout_s: float = 30.0
    # router-level shed Retry-After: base + uniform [0, jitter) — the
    # serving stack's anti-thundering-herd idiom at the fleet edge
    shed_retry_after_s: float = 1.0
    retry_jitter_s: float = 2.0

    # --- data plane (fleet/dataplane.py) ---
    data_plane: str = "evloop"           # evloop | threads — the relay
    # hot path: a selectors-based event loop (the ~5x relays/s plane) or
    # the original thread-per-connection fallback
    relay_workers: int = 1               # evloop shards accepting on the
    # same port via SO_REUSEPORT (>1 needs kernel support; threads
    # plane ignores it)
    idle_timeout_s: float = 60.0         # close keep-alive connections
    # silent this long (counted dfd_router_idle_closed_total)
    header_timeout_s: float = 10.0       # slowloris bound: a request
    # head must arrive whole within this window (408 + close)
    max_buffer_bytes: int = 1 << 20      # per-connection relay buffer
    # bound: larger responses stream with backpressure (evloop); a
    # stalled reader whose buffer stays full between requests is shed

    # --- migration (fleet/migrate.py) ---
    migrate_timeout_s: float = 30.0      # per-stream export/restore bound
    drain_on_exit: bool = False          # drain spawned replicas' streams
    # before terminating them on shutdown

    # --- edge verdict cache (cache/) ---
    # optional response cache for POST /score at the routing tier, keyed
    # by raw body digest + the fleet weights-epoch (the set of per-model
    # checkpoint fingerprints scraped off every replica's /readyz): a
    # mixed-fingerprint rollout changes the epoch and bypasses the cache
    # until the fleet converges.  0 entries disables the edge probe
    edge_cache_entries: int = 0
    edge_cache_ttl_s: float = 2.0

    # --- autoscaling (fleet/autoscaler.py) ---
    # the SLO-driven control loop: sample the fleet every
    # --autoscale-interval-s, scale up when the router p99 / shed rate /
    # per-replica depth breach for --autoscale-up-samples consecutive
    # ticks, scale in (drain-first, lossless) after
    # --autoscale-down-samples idle ticks; decisions are deterministic
    # from the recorded sample trace (--autoscale-trace + the golden
    # replay test pin it)
    autoscale: bool = False
    slo_p99_ms: float = 250.0            # the breach line
    min_replicas: int = 1                # hard floor (dead children
    # re-spawn to it even with no load)
    max_replicas: int = 4                # capacity slots shared with
    # the backfill tenant
    autoscale_interval_s: float = 1.0
    autoscale_up_samples: int = 2
    autoscale_down_samples: int = 5
    autoscale_up_cooldown_s: float = 5.0
    autoscale_down_cooldown_s: float = 15.0
    autoscale_shed_high: float = 0.01    # shed fraction breach line
    autoscale_depth_high: float = 8.0    # per-replica depth breach line
    autoscale_depth_low: float = 1.0     # per-replica depth idle line
    autoscale_trace: str = ""            # JSONL decision trace path
    # (sample + decision per tick; replayable via
    # fleet.autoscaler.replay_trace)
    spawn_grace_s: float = 900.0         # a spawned child is *warming*,
    # not down, until it binds its port or this window expires
    settle_timeout_s: float = 20.0       # scale-in: bounded wait for a
    # drained replica's inflight to reach zero before terminate
    # standby pool: keep N fully-warmed but UNREGISTERED
    # replicas parked (counted as neither ready nor warming) so a
    # scale-up is a registry promotion in milliseconds instead of a
    # cold spawn; standbys occupy capacity slots (max_replicas) and the
    # backfill tenant's slot math counts them
    standby_replicas: int = 0

    # --- backfill tenant: idle capacity runs backfill ---
    backfill_tenant: str = ""            # manifest path (enables the
    # tenant: idle capacity slots run runners/backfill.py workers that
    # yield on a traffic spike via SIGTERM -> exit-75 lease release)
    backfill_out: str = ""               # the tenant's shared run dir
    backfill_args: str = ""              # extra CLI for every tenant
    # worker (shlex-split), e.g. "--data-packed ... --model ..."
    backfill_max_workers: int = 0        # cap (0 = all idle slots)
    backfill_yield_timeout_s: float = 30.0

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.spawn_runner not in ("serve", "stream"):
            raise ValueError(f"--spawn-runner must be serve|stream, got "
                             f"{self.spawn_runner!r}")
        if int(self.spawn) < 0:
            raise ValueError(f"--spawn must be >= 0, got {self.spawn}")
        if int(self.virtual_nodes) < 1:
            raise ValueError(f"--virtual-nodes must be >= 1, got "
                             f"{self.virtual_nodes}")
        if int(self.route_retries) < 0:
            raise ValueError(f"--route-retries must be >= 0, got "
                             f"{self.route_retries}")
        if int(self.health_fail_after) < 1:
            raise ValueError(f"--health-fail-after must be >= 1, got "
                             f"{self.health_fail_after}")
        if self.data_plane not in ("evloop", "threads"):
            raise ValueError(f"--data-plane must be evloop|threads, got "
                             f"{self.data_plane!r}")
        if int(self.relay_workers) < 1:
            raise ValueError(f"--relay-workers must be >= 1, got "
                             f"{self.relay_workers}")
        if int(self.max_buffer_bytes) < 4096:
            raise ValueError(f"--max-buffer-bytes must be >= 4096, got "
                             f"{self.max_buffer_bytes}")
        if int(self.edge_cache_entries) < 0:
            raise ValueError(f"--edge-cache-entries must be >= 0 "
                             f"(0 = off), got {self.edge_cache_entries}")
        if float(self.edge_cache_ttl_s) <= 0:
            raise ValueError(f"--edge-cache-ttl-s must be > 0, got "
                             f"{self.edge_cache_ttl_s}")
        for name in ("scrape_interval_s", "scrape_timeout_s",
                     "upstream_timeout_s", "migrate_timeout_s",
                     "shed_retry_after_s", "idle_timeout_s",
                     "header_timeout_s"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(f"--{name.replace('_', '-')} must be "
                                 f"> 0, got {getattr(self, name)}")
        if float(self.retry_jitter_s) < 0:
            raise ValueError(f"--retry-jitter-s must be >= 0, got "
                             f"{self.retry_jitter_s}")
        if int(self.min_replicas) < 1:
            raise ValueError(f"--min-replicas must be >= 1, got "
                             f"{self.min_replicas}")
        if int(self.max_replicas) < int(self.min_replicas):
            raise ValueError(
                f"--max-replicas ({self.max_replicas}) must be >= "
                f"--min-replicas ({self.min_replicas})")
        if int(self.autoscale_up_samples) < 1 or \
                int(self.autoscale_down_samples) < 1:
            raise ValueError("--autoscale-up-samples / "
                             "--autoscale-down-samples must be >= 1")
        if float(self.autoscale_depth_low) > \
                float(self.autoscale_depth_high):
            raise ValueError("--autoscale-depth-low must be <= "
                             "--autoscale-depth-high (the hysteresis "
                             "dead band)")
        if int(self.backfill_max_workers) < 0:
            raise ValueError(f"--backfill-max-workers must be >= 0, "
                             f"got {self.backfill_max_workers}")
        if int(self.standby_replicas) < 0:
            raise ValueError(f"--standby-replicas must be >= 0, got "
                             f"{self.standby_replicas}")
        if int(self.standby_replicas) > 0 and not self.autoscale:
            raise ValueError("--standby-replicas needs --autoscale "
                             "(the autoscaler owns the standby pool)")
        for name in ("slo_p99_ms", "autoscale_interval_s",
                     "spawn_grace_s", "settle_timeout_s",
                     "backfill_yield_timeout_s"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(f"--{name.replace('_', '-')} must be "
                                 f"> 0, got {getattr(self, name)}")
        for name in ("autoscale_up_cooldown_s",
                     "autoscale_down_cooldown_s",
                     "autoscale_shed_high", "autoscale_depth_low"):
            if float(getattr(self, name)) < 0:
                raise ValueError(f"--{name.replace('_', '-')} must be "
                                 f">= 0, got {getattr(self, name)}")

    def replica_urls(self) -> List[str]:
        return [u.strip() for u in str(self.replicas).split(",")
                if u.strip()]

    def validate_required(self) -> "RouterConfig":
        """Launch-surface check (two-stage parse builds an all-defaults
        instance first): the router needs a fleet to route over."""
        if not self.replica_urls() and int(self.spawn) < 1:
            raise ValueError("give the router a fleet: --replicas "
                             "url[,url...] and/or --spawn N")
        if self.backfill_tenant and not self.autoscale:
            raise ValueError("--backfill-tenant needs --autoscale (the "
                             "control loop is the tenant's scheduler)")
        if self.backfill_tenant and not self.backfill_out:
            raise ValueError("--backfill-tenant needs --backfill-out "
                             "(the tenant's shared run dir)")
        return self

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None
                  ) -> "RouterConfig":
        return super().from_args(argv).validate_required()
