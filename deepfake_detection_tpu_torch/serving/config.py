"""Knob surface of the serving replica: :class:`ServeConfig`.

The counterpart of ``ServeConfig`` and ``parse_model_spec`` in
``deepfake_detection_tpu/config.py``: the same fields, defaults and checks,
every field a ``--dashed-flag`` (a ``-c`` YAML or JSON file resets the
defaults, the command line overrides them), plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch programs, for the tests).

``--dtype`` and a ``--models`` entry's ``dtype`` take f32, bf16 or int8
(aliases float32, bfloat16): the weight-only PTQ of ``serving/quant.py``.
The flags of pieces the port does not have yet parse, and raise
``NotImplementedError`` naming their ROADMAP item when set away from their
defaults: ``--warmstart-dir`` (the executable store of
``serving/warmstart.py``; a CUDA graph cannot be serialized, item 10's warm
start), and the XLA-only ``--compile-cache-dir`` and
``--single-thread-xla``.  ``--warm-parallel`` above 1 raises too: the
captures of one engine share one memory pool and run one at a time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["FlagConfig", "ServeConfig", "parse_model_spec"]

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
    warmstart_dir: str = ""              # not ported (raises when set)
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
        if self.warmstart_dir:
            raise NotImplementedError(
                "--warmstart-dir: the executable store of "
                "serving/warmstart.py is not ported (a CUDA graph cannot be "
                "serialized; ROADMAP Queue 1, item 10, warm start)")
        if self.compile_cache_dir:
            raise NotImplementedError(
                "--compile-cache-dir is XLA's persistent compilation cache; "
                "the port compiles no XLA (its kernels' build cache is "
                "build/kernels/; ROADMAP Queue 1, item 10, warm start)")
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
