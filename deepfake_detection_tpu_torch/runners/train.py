"""Training runner.

Counterpart of ``deepfake_detection_tpu/runners/train.py`` for one card:
build the model, optimizer (linear LR scaling), schedule, EMA, datasets,
loaders and steps; then per epoch train, validate (the EMA's metrics
replace the model's when it is kept), step the schedule on the eval
metric, and write the epoch's checkpoints.

Usage, ``scripts/train.sh``'s command line on a clip tree (the restart
loop around it is ``scripts/train_torch.sh``)::

    python -m deepfake_detection_tpu_torch.runners.train \\
        --data ROOT --model efficientnet_deepfake_v4 --model-version v4 \\
        --input-size-v2 12,600,600 -b 3 --opt rmsproptf --basic-lr 5e-7 \\
        --sched step --decay-epochs 2 --decay-rate .92 --epochs 200 --amp \\
        --reprob 0.2 --remax 0.05 --flicker 0.05 --rotate-range 5 \\
        --blur-prob 0.05 --bn-momentum 0.001 --mixup 0.1 --label-balance \\
        --eval-metric loss --workers 8 --experiment flagship \\
        --auto-resume --recovery-interval 500

``ROOT`` holds ``real_list.txt``/``fake_list.txt`` (``name:num`` lines) and
``{real,fake}/<clip>/<i>.jpg`` frames (the port's own JPEG decoder, no
Pillow) or the ``<i>.npy`` beside each;
``--data-packed DIR`` reads a pack of it instead (``data/packed.py``).
``--dataset synthetic`` trains on seeded noise clips (no augmentation), and
the TimeSformer runs with ``--model timesformer_base_patch25_600
--model-version "" --attn-impl flash``.

The augment chain runs where the JAX runner runs it.  ``--augment-device
off`` (the default, as the JAX package's) is the host chain: the native
warp (or, with ``--host-geom``, the sequential rotate/flip/resize/crop),
Pillow's blur, and under ``--mixup`` (as ``scripts/train.sh`` sets it) the
colour jitter, the flicker and the blend, each computed as Pillow 12
computes it without Pillow (``data/imaging.py`` over
``native/imaging.cc``); without mixup, jitter and flicker run on the card
unless ``--host-color-jitter``.  ``--augment-device on`` renders the whole
chain on the card.  The card's jitter/flicker and erasing draw from torch
generators, not ``jax.random`` (``data/loader.py``).

AugMix (``--aug-splits N --jsd --split-bn``, timm's recipe; ``--mixup 0``,
which it excludes): each sample becomes its clean view and ``N - 1``
AugMix views (``data/auto_augment.py``, Pillow's ops without Pillow), all
on the host chain, stacked split-major, so a step sees ``N × -b`` rows;
``--jsd`` trains on the JSD consistency loss; ``--split-bn`` gives every BN
``N - 1`` auxiliary BNs (``ops/norm.py`` ``SplitBatchNorm2d``, saved,
averaged by the EMA and resumed with the rest of the state) that
normalize the augmented splits, the depthwise stages still going through
their kernels; eval reads the main BN alone.  The flagship's line::

    ... scripts/train.sh's flags ... --mixup 0 --aug-splits 3 --jsd \
        --split-bn

Normalization follows the model's name as in the JAX runner
(``data/config.py``: Inception's 0.5 for ``ception``/``nasnet`` names,
DPN's for ``dpn``, ImageNet's otherwise) unless ``--mean``/``--std`` give
a frame's three values (or one for all three).  The input size is
``--input-size-v2``, ``--input-size`` or ``--img-size``, else the model's
``default_cfg`` (where the JAX runner takes 3×224²; ROADMAP, faults in the
JAX package).  The model flags ``--num-classes``, ``--drop``,
``--drop-path``, ``--drop-block`` (the ResNet-derived families),
``--bn-eps``, the schedule's ``--cooldown-epochs``, ``--patience-epochs``
and ``--min-lr``, ``--model-ema-decay`` and ``--pack-image-size`` (the
pack's resolution, asserted) are the JAX runner's.

Beyond train.sh's line, the JAX runner's optimization flags: ``--grad-accum
N`` (the loader's batch is ``-b × N``, split strided into N microbatches
that accumulate into one optimizer step, the lr scaled by N), every
optimizer of the JAX factory (``--opt``, with ``--opt-eps``,
``--momentum``, ``--weight-decay``; ``optim/factory.py``), the schedule's
``--warmup-epochs``, ``--warmup-lr``, ``--lr-noise*``, ``--lr-cycle-*``
and ``--mixup-off-epoch``, and ``--initial-checkpoint`` (a port or timm
state dict, non-strict, fanned out to the aux BNs under ``--split-bn``).
Validation reports ``auc`` (P(real) ranked over the epoch) beside loss and
top-1, ``--eval-metric auc`` picks the best checkpoint by it, and each
epoch appends a row to the run directory's ``summary.csv``.

Compute follows the JAX runner's policy: the model computes in
``--compute-dtype`` (default ``bfloat16``, as the JAX config's) when
``--amp`` is set or that dtype is not ``float32``, so only
``--compute-dtype float32`` without ``--amp`` is f32 (with TF32 off on the
card).  Parameters, gradients, the optimizer, the EMA and the guard stay
f32 (``models.helpers.set_compute_dtype``); the loaders hand over batches
in the compute dtype.

Recovery (``train/resilience.py``, ``train/checkpoint.py``): a recovery
snapshot every ``--recovery-interval`` batches and at each epoch's last;
``--auto-resume`` continues from the newest loadable one (falling back past
corrupt files to the ``_bak`` and ``model_best`` copies) at its exact loop
position, in a stable output directory; ``--resume PATH`` seeds from a
checkpoint (``--no-resume-opt``, ``--start-epoch``).  SIGTERM/SIGINT stop
at a step boundary with a snapshot on disk and exit 75; K bad steps in a
row (``--guard-*``) rewind to the last snapshot; ``--watchdog-timeout``
seconds without a step dump every thread's stack and exit 85.  The
``DFD_CHAOS`` points of ``chaos.py`` inject those faults.

Observability (``obs/``): telemetry is on by default (``--no-telemetry``
turns it off): the run directory's ``telemetry.jsonl`` gets one record a
drain (the data / device / host breakdown of the window, throughput and
the live MFU gauge against the card's dense bf16 peak) and the run's
lifecycle events (``run_start``, ``resume``, ``rewind``, ``epoch_end``,
``preempted``, ``run_end``); ``--metrics-port`` serves it as Prometheus
text (``/metrics``, ``/healthz``); ``SIGUSR2`` or a ``PROFILE`` file in the
run directory captures a ``torch.profiler`` trace of the next
``--profile-capture`` steps under ``profile/``.  ``python
tools/obs_report.py RUN_DIR`` summarizes a run.

Training runs on ``--device cuda`` unless the caller asks for ``cpu`` (the
plain PyTorch path the tests use).  Every flag of ``scripts/train.sh``
parses; an unknown flag is an argparse error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..data.config import resolve_input_size, resolve_mean_std
from ..data.dataset import DeepFakeClipDataset, SyntheticDataset
from ..data.loader import (DeviceLoader, create_loader,
                           create_deepfake_loader_v3)
from ..data.mixup import FastCollateMixup
from ..data.packed import PackedDataset
from ..losses import create_loss_fn, cross_entropy
from ..models import (create_deepfake_model, create_deepfake_model_v3,
                      create_deepfake_model_v4, create_model)
from ..models.factory import default_cfg, resolve_device
from ..models.helpers import load_initial_checkpoint
from ..optim.factory import create_optimizer
from ..scheduler.factory import create_scheduler
from ..train.checkpoint import (CheckpointCorrupt, CheckpointSaver,
                                find_resume_candidates, restore_train_state,
                                wait_pending_saves)
from ..train.resilience import (EXIT_PREEMPTED, Preempted, Resilience,
                                RewindRequested)
from ..train.state import TrainState, create_train_state, set_learning_rate
from ..train.steps import make_eval_step, make_train_step
from ..train.trainer import train_one_epoch, validate
from ..utils.summary import update_summary

_logger = logging.getLogger("train")

__all__ = ["TrainConfig", "Run", "parse_args", "setup", "build_model",
           "build_datasets", "build_loaders", "main", "launch_main",
           "model_dtype"]

_MODEL_FACTORIES = {"": create_model, "v1": create_deepfake_model,
                    "v3": create_deepfake_model_v3,
                    "v4": create_deepfake_model_v4}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainConfig:
    """The ported subset of the JAX package's ``TrainConfig``, with its
    defaults."""
    data: str = ""
    eval_data: str = ""
    dataset: str = "deepfake_v3"
    data_packed: str = ""
    train_split: float = 0.95
    split_seed: int = 42
    label_balance: bool = False
    noise_fake: float = 0.0
    workers: int = 8
    prefetch_depth: int = 2
    # the host transport: 'thread' (threads of this process) or 'shm'
    # (spawned worker processes into a shared-memory ring of batch slabs,
    # data/shm_ring.py), its slabs in flight and its stalled-worker kill (s)
    loader_backend: str = "thread"
    ring_depth: int = 4
    worker_heartbeat: float = 120.0
    color_jitter: float = 0.4
    reprob: float = 0.0
    remode: str = "const"
    recount: int = 1
    resplit: bool = False
    remax: float = 0.4
    flicker: float = 0.0
    rotate_range: float = 0.0
    blur_prob: float = 0.0
    # AugMix views a sample (0: none), the JSD loss over them, and AdvProp
    # split BN (an aux BN for each augmented split)
    aug_splits: int = 0
    jsd: bool = False
    split_bn: bool = False
    augment_device: str = "off"
    # the host chain's parity escape hatches: jitter/flicker on the host
    # under no mixup; the sequential geometry instead of the one warp
    host_color_jitter: bool = False
    host_geom: bool = False
    eval_crop: str = "random"
    # the expected resolution of --data-packed's pack (0: any)
    pack_image_size: int = 0
    model: str = "efficientnet_deepfake_v4"
    model_version: str = "v4"
    num_classes: int = 2
    # the global pool: avg | max | avgmax | catavgmax (a 2× classifier)
    gp: str = "avg"
    drop: float = 0.0
    drop_path: Optional[float] = None
    # the ResNet-derived families take it; the factory drops it with the
    # JAX warning for the others
    drop_block: Optional[float] = None
    # TF BN defaults (momentum 0.01, eps 1e-3); passed as given, so a tf_
    # model trains with torch's unless asked, as the JAX runner does
    bn_tf: bool = False
    bn_momentum: Optional[float] = None
    bn_eps: Optional[float] = None
    input_size_v2: Optional[Tuple[int, int, int]] = None
    input_size_flag: Optional[Tuple[int, int, int]] = None
    img_size: Optional[int] = None
    # a frame's normalization (one value: every channel); None: the model
    # name's constants (data/config.py)
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None
    batch_size: int = 3
    # microbatches accumulated into one optimizer step (the loader's batch
    # is batch_size × grad_accum, the eval batch is not multiplied)
    grad_accum: int = 1
    opt: str = "rmsproptf"
    opt_eps: float = 1e-8
    momentum: float = 0.9
    weight_decay: float = 1e-5
    lr: Optional[float] = None
    basic_lr: float = 5e-7
    sched: str = "step"
    epochs: int = 200
    decay_epochs: float = 2.0
    decay_rate: float = 0.92
    warmup_lr: float = 1e-4
    warmup_epochs: int = 0
    cooldown_epochs: int = 10
    patience_epochs: int = 10
    lr_noise: Optional[Tuple[float, ...]] = None
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0
    # accepted and unused, as in the JAX factory (t_mul 1, one cycle)
    lr_cycle_mul: float = 1.0
    lr_cycle_limit: int = 1
    min_lr: float = 1e-5
    clip_grad: Optional[float] = None
    mixup: float = 0.0
    mixup_off_epoch: int = 0
    smoothing: float = 0.1
    model_ema: bool = False
    model_ema_decay: float = 0.9998
    amp: bool = False
    compute_dtype: str = "bfloat16"
    initial_checkpoint: str = ""
    resume: str = ""
    no_resume_opt: bool = False
    start_epoch: Optional[int] = None
    auto_resume: bool = False
    recovery_interval: int = 0
    guard_nonfinite: str = "skip"
    guard_spike_window: int = 0
    guard_spike_zmax: float = 8.0
    guard_rewind_after: int = 3
    guard_rewind_limit: int = 2
    watchdog_timeout: float = 0.0
    seed: int = 42
    log_interval: int = 50
    eval_metric: str = "loss"
    output: str = "./output"
    experiment: str = ""
    device: str = "cuda"
    attn_impl: str = ""
    # observability (obs/): the telemetry tracker and its JSONL log,
    # default on; a Prometheus endpoint (0 = off); the on-demand profiler
    # window in steps (0 = no trigger)
    no_telemetry: bool = False
    metrics_port: int = 0
    profile_capture: int = 20

    def resolved_lr(self, world_size: int = 1) -> float:
        """Linear LR scaling: ``batch × world × basic_lr`` unless ``lr``;
        the runner passes ``grad_accum`` as the world, as the JAX runner
        scales by dp × grad_accum."""
        if self.lr is not None:
            return self.lr
        return self.batch_size * world_size * self.basic_lr

    def input_size(self) -> Tuple[int, int, int]:
        """(C, H, W): ``--input-size-v2``, ``--input-size`` or
        ``--img-size`` (3 channels), else the registered model's default
        (``data/config.py``)."""
        return resolve_input_size(
            self.input_size_v2, self.input_size_flag, self.img_size) \
            or tuple(default_cfg(self.model)["input_size"])

    def mean_std(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        """A frame's ``(mean, std)``: ``--mean``/``--std`` or the model
        name's constants, as the JAX runner resolves them."""
        return resolve_mean_std(self.model, self.input_size()[0], self.mean,
                                self.std)


def _ints(s: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in s.split(","))


def _floats(s: str) -> Tuple[float, ...]:
    return tuple(float(v) for v in s.split(","))


def model_dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    """The model's compute dtype by the JAX runner's rule: the compute
    dtype under ``--amp`` or when it is not f32, else None (f32)."""
    if cfg.amp or cfg.compute_dtype != "float32":
        return _DTYPES[cfg.compute_dtype]
    return None


def parse_args(argv=None) -> TrainConfig:
    """``argv`` → :class:`TrainConfig`; ``--augment-device on`` with
    ``--host-geom`` or ``--host-color-jitter`` raises ``ValueError``, as
    the JAX config does."""
    d = TrainConfig()
    # no abbreviations: an unported flag (--drop, the JAX runner's dropout)
    # must not parse as a prefix of a ported one (--drop-block)
    p = argparse.ArgumentParser(
        description="deepfake training (PyTorch port, one card)",
        allow_abbrev=False)
    p.add_argument("--data", default=d.data,
                   help="clip root(s), ':'-separated")
    p.add_argument("--eval-data", default=d.eval_data)
    p.add_argument("--dataset", choices=["deepfake_v3", "synthetic"],
                   default=d.dataset)
    p.add_argument("--data-packed", default=d.data_packed,
                   help="a pack of --data (data/packed.py)")
    p.add_argument("--train-split", type=float, default=d.train_split)
    p.add_argument("--split-seed", type=int, default=d.split_seed)
    p.add_argument("--label-balance", action="store_true")
    p.add_argument("--noise-fake", type=float, default=d.noise_fake)
    p.add_argument("--workers", type=int, default=d.workers)
    p.add_argument("--prefetch-depth", type=int, default=d.prefetch_depth)
    p.add_argument("--loader-backend", choices=["thread", "shm"],
                   default=d.loader_backend,
                   help="host transport: threads of this process, or "
                        "spawned workers into a shared-memory ring")
    p.add_argument("--ring-depth", type=int, default=d.ring_depth,
                   help="shm: batch slabs in flight (>= 3)")
    p.add_argument("--worker-heartbeat", type=float,
                   default=d.worker_heartbeat,
                   help="shm: seconds a worker may hold a task silently "
                        "before it is killed and respawned")
    p.add_argument("--color-jitter", type=float, default=d.color_jitter)
    p.add_argument("--reprob", type=float, default=d.reprob)
    p.add_argument("--remode", default=d.remode)
    p.add_argument("--recount", type=int, default=d.recount)
    p.add_argument("--resplit", action="store_true")
    p.add_argument("--remax", type=float, default=d.remax)
    p.add_argument("--flicker", type=float, default=d.flicker)
    p.add_argument("--rotate-range", type=float, default=d.rotate_range)
    p.add_argument("--blur-prob", type=float, default=d.blur_prob)
    p.add_argument("--aug-splits", type=int, default=d.aug_splits,
                   help="AugMix views a sample, the clean one included "
                        "(0: no AugMix; >1 excludes --mixup)")
    p.add_argument("--jsd", action="store_true",
                   help="the AugMix JSD consistency loss (needs "
                        "--aug-splits > 1)")
    p.add_argument("--split-bn", action="store_true",
                   help="an auxiliary BN for each augmented split (needs "
                        "--aug-splits > 1 or --resplit)")
    p.add_argument("--augment-device", choices=["on", "off"],
                   default=d.augment_device,
                   help="off: the host chain; on: the whole chain on the "
                        "device")
    p.add_argument("--host-color-jitter", action="store_true",
                   help="colour jitter and flicker on the host")
    p.add_argument("--host-geom", action="store_true",
                   help="the sequential rotate/flip/resize/crop on the host "
                        "instead of the one native warp")
    p.add_argument("--eval-crop", choices=["random", "center"],
                   default=d.eval_crop)
    p.add_argument("--pack-image-size", type=int, default=d.pack_image_size,
                   help="assert the pack's resolution (needs --data-packed; "
                        "0: any)")
    p.add_argument("--model", default=d.model)
    p.add_argument("--model-version", default=d.model_version)
    p.add_argument("--gp", choices=["avg", "max", "avgmax", "catavgmax"],
                   default=d.gp, help="global pool")
    p.add_argument("--num-classes", type=int, default=d.num_classes)
    p.add_argument("--drop", type=float, default=d.drop,
                   help="dropout rate before the classifier")
    p.add_argument("--drop-path", type=float, default=d.drop_path)
    p.add_argument("--drop-block", type=float, default=d.drop_block,
                   help="DropBlock rate (resnet, gluon_resnet, res2net and "
                        "sknet; dropped with a warning elsewhere)")
    p.add_argument("--bn-tf", action="store_true",
                   help="TF BN defaults (momentum 0.01, eps 1e-3)")
    p.add_argument("--bn-momentum", type=float, default=d.bn_momentum)
    p.add_argument("--bn-eps", type=float, default=d.bn_eps)
    p.add_argument("--input-size-v2", type=_ints, default=d.input_size_v2)
    p.add_argument("--input-size", type=_ints, dest="input_size_flag",
                   default=d.input_size_flag, help="C,H,W (after "
                   "--input-size-v2)")
    p.add_argument("--img-size", type=int, default=d.img_size,
                   help="H = W with 3 channels (after --input-size)")
    p.add_argument("--mean", type=_floats, default=d.mean,
                   help="a frame's mean, ','-separated (one value: every "
                        "channel); default: by model name")
    p.add_argument("--std", type=_floats, default=d.std)
    p.add_argument("-b", "--batch-size", type=int, default=d.batch_size)
    p.add_argument("--grad-accum", type=int, default=d.grad_accum,
                   help="microbatches of -b accumulated into one optimizer "
                        "step")
    p.add_argument("--opt", default=d.opt,
                   help="sgd, adam, adamw, nadam, radam, adadelta, rmsprop, "
                        "rmsproptf, novograd, nvnovograd, lamb; a "
                        "lookahead_ prefix; fused* aliases")
    p.add_argument("--opt-eps", type=float, default=d.opt_eps)
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--basic-lr", type=float, default=d.basic_lr)
    p.add_argument("--sched", default=d.sched)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--decay-epochs", type=float, default=d.decay_epochs)
    p.add_argument("--decay-rate", type=float, default=d.decay_rate)
    p.add_argument("--cooldown-epochs", type=int, default=d.cooldown_epochs)
    p.add_argument("--patience-epochs", type=int,
                   default=d.patience_epochs)
    p.add_argument("--min-lr", type=float, default=d.min_lr)
    p.add_argument("--warmup-lr", type=float, default=d.warmup_lr)
    p.add_argument("--warmup-epochs", type=int, default=d.warmup_epochs,
                   help="epochs of linear warmup from --warmup-lr; epoch 0 "
                        "trains at the full lr, as in the JAX runner")
    p.add_argument("--lr-noise", type=_floats, default=d.lr_noise,
                   help="noise range as fractions of the epochs, "
                        "','-separated")
    p.add_argument("--lr-noise-pct", type=float, default=d.lr_noise_pct)
    p.add_argument("--lr-noise-std", type=float, default=d.lr_noise_std)
    p.add_argument("--lr-cycle-mul", type=float, default=d.lr_cycle_mul)
    p.add_argument("--lr-cycle-limit", type=int, default=d.lr_cycle_limit)
    p.add_argument("--clip-grad", type=float, default=d.clip_grad)
    p.add_argument("--mixup", type=float, default=d.mixup)
    p.add_argument("--mixup-off-epoch", type=int, default=d.mixup_off_epoch,
                   help="turn the mixup off from this epoch (0: never)")
    p.add_argument("--smoothing", type=float, default=d.smoothing)
    p.add_argument("--model-ema", action="store_true")
    p.add_argument("--model-ema-decay", type=float,
                   default=d.model_ema_decay)
    p.add_argument("--amp", action="store_true",
                   help="compute in --compute-dtype (the JAX runner's rule)")
    p.add_argument("--compute-dtype", choices=sorted(_DTYPES),
                   default=d.compute_dtype)
    p.add_argument("--initial-checkpoint", default=d.initial_checkpoint,
                   help="start from this port/timm state dict (non-strict; "
                        "plain BNs fan out to --split-bn's aux BNs)")
    p.add_argument("--resume", default=d.resume,
                   help="seed the run from this checkpoint")
    p.add_argument("--no-resume-opt", action="store_true")
    p.add_argument("--start-epoch", type=int, default=d.start_epoch)
    p.add_argument("--auto-resume", action="store_true",
                   help="continue from the run directory's newest snapshot")
    p.add_argument("--recovery-interval", type=int,
                   default=d.recovery_interval,
                   help="a recovery snapshot every N batches (0: none)")
    p.add_argument("--guard-nonfinite", choices=["off", "skip"],
                   default=d.guard_nonfinite)
    p.add_argument("--guard-spike-window", type=int,
                   default=d.guard_spike_window)
    p.add_argument("--guard-spike-zmax", type=float,
                   default=d.guard_spike_zmax)
    p.add_argument("--guard-rewind-after", type=int,
                   default=d.guard_rewind_after)
    p.add_argument("--guard-rewind-limit", type=int,
                   default=d.guard_rewind_limit)
    p.add_argument("--watchdog-timeout", type=float,
                   default=d.watchdog_timeout,
                   help="seconds without a step before exit 85 (0: off)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--log-interval", type=int, default=d.log_interval)
    p.add_argument("--eval-metric", choices=["loss", "prec1", "auc"],
                   default=d.eval_metric)
    p.add_argument("--output", default=d.output)
    p.add_argument("--experiment", default=d.experiment)
    p.add_argument("--device", default=d.device,
                   help="torch device; the CPU runs the plain PyTorch path")
    p.add_argument("--attn-impl", default=d.attn_impl,
                   help="ViT/TimeSformer attention: full | flash")
    p.add_argument("--no-telemetry", action="store_true",
                   help="no telemetry.jsonl, /metrics or profiler triggers")
    p.add_argument("--metrics-port", type=int, default=d.metrics_port,
                   help="serve /metrics and /healthz on this port (0: off)")
    p.add_argument("--profile-capture", type=int, default=d.profile_capture,
                   help="steps a SIGUSR2/PROFILE-file trace captures "
                        "(0: off)")
    ns = vars(p.parse_args(argv))
    if ns["augment_device"] == "on" and ns["host_geom"]:
        raise ValueError("--augment-device on renders the geometric warp on "
                         "device; it conflicts with the --host-geom parity "
                         "escape hatch — pick one")
    if ns["augment_device"] == "on" and ns["host_color_jitter"]:
        raise ValueError("--augment-device on leaves no host transform "
                         "stage for --host-color-jitter to run in — pick one")
    if ns["grad_accum"] < 1:
        raise ValueError(f"--grad-accum must be >= 1, got "
                         f"{ns['grad_accum']}")
    if ns["pack_image_size"] < 0:
        raise ValueError(f"--pack-image-size must be >= 0, got "
                         f"{ns['pack_image_size']}")
    if ns["pack_image_size"] and not ns["data_packed"]:
        raise ValueError("--pack-image-size only makes sense with "
                         "--data-packed (it asserts the pack's resolution, "
                         "not a resize)")
    if ns["ring_depth"] < 3:
        raise ValueError("--ring-depth must be >= 3 (double buffering "
                         f"needs one spare slab), got {ns['ring_depth']}")
    if not 0 <= ns["metrics_port"] <= 65535:
        raise ValueError(f"--metrics-port must be in [0, 65535], got "
                         f"{ns['metrics_port']}")
    if ns["profile_capture"] < 0:
        raise ValueError(f"--profile-capture must be >= 0, got "
                         f"{ns['profile_capture']}")
    return TrainConfig(**ns)


@dataclass
class Run:
    """Everything :func:`main` drives, built by :func:`setup`."""
    cfg: TrainConfig
    device: torch.device
    state: TrainState
    train_step: Any
    eval_step: Any
    eval_step_ema: Any
    train_loader: DeviceLoader
    eval_loader: DeviceLoader
    lr_scheduler: Any
    num_epochs: int


def build_model(cfg: TrainConfig, device) -> torch.nn.Module:
    """The model through the factory's family rules: BN arguments
    (``--bn-tf``, ``--bn-eps`` among them) reach only the EfficientNet and
    MobileNetV3 families, ``attn_impl`` and the input size only the
    transformers, ``--drop-block`` only the ResNet-derived families (the
    others warn, as JAX); ``--num-classes``, ``--drop``, ``--drop-path``,
    ``--gp`` and the compute dtype (:func:`model_dtype`) every family
    (the TimeSformer refuses a dropout); ``--split-bn`` makes every BN
    ``split<max(aug_splits, 2)>``."""
    factory = _MODEL_FACTORIES.get(cfg.model_version)
    if factory is None:
        raise ValueError(f"--model-version {cfg.model_version!r}: one of "
                         f"{sorted(_MODEL_FACTORIES)}")
    c, h, w = cfg.input_size()
    kwargs = {}
    if cfg.split_bn:
        # AdvProp split BN: a BN for each augmentation split
        if not (cfg.aug_splits > 1 or cfg.resplit):
            raise ValueError("--split-bn needs --aug-splits > 1 or "
                             "--resplit")
        kwargs["norm_layer"] = f"split{max(cfg.aug_splits, 2)}"
    if cfg.attn_impl:
        if cfg.attn_impl in ("ring", "ring_flash", "ulysses"):
            raise ValueError(
                f"--attn-impl {cfg.attn_impl}: sequence-parallel attention "
                f"needs a mesh and token-sharded inputs (not ported: ROADMAP "
                f"Queue 1 item 13); the CLI supports 'full' and 'flash'")
        kwargs["attn_impl"] = cfg.attn_impl
    return factory(cfg.model, num_classes=cfg.num_classes, in_chans=c,
                   drop_rate=cfg.drop, drop_path_rate=cfg.drop_path,
                   drop_block_rate=cfg.drop_block, bn_tf=cfg.bn_tf,
                   global_pool=cfg.gp, bn_momentum=cfg.bn_momentum,
                   bn_eps=cfg.bn_eps, img_size=(h, w), device=device,
                   seed=cfg.seed, dtype=model_dtype(cfg), **kwargs)


def setup(cfg: TrainConfig) -> Run:
    """Model, state, steps, loaders and schedule for ``cfg``.  The lr is
    scaled by ``grad_accum`` (the optimizer step sees batch × grad_accum
    samples).  As in the JAX runner, the optimizer starts at that full lr
    and the schedule writes its lr only at the end of an epoch (or at a
    resume's start), so with ``--warmup-epochs`` epoch 0 trains at the full
    lr and the warmup shows from epoch 1; ROADMAP's JAX-fault list records
    the choice."""
    device = resolve_device(cfg.device)
    if device.type == "cuda":
        # f32 parity: cuDNN convolutions would otherwise run in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg, device)
    _logger.info("Model %s created, param count: %d", cfg.model,
                 sum(p.numel() for p in model.parameters()))
    if cfg.initial_checkpoint:
        # before the optimizer and the EMA copy the weights
        load_initial_checkpoint(model, cfg.initial_checkpoint,
                                split_bn=cfg.split_bn)
    if cfg.lr_cycle_mul != 1.0 or cfg.lr_cycle_limit != 1:
        _logger.warning("--lr-cycle-mul/--lr-cycle-limit are accepted and "
                        "unused, as in the JAX scheduler factory")
    lr = cfg.resolved_lr(world_size=cfg.grad_accum)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = create_train_state(model, create_optimizer(cfg, model, lr),
                               with_ema=cfg.model_ema,
                               ema_decay=cfg.model_ema_decay,
                               generator=generator)
    lr_scheduler, num_epochs = create_scheduler(cfg, base_lr=lr)
    train_loader, eval_loader = build_loaders(cfg, device,
                                              *build_datasets(cfg))
    train_step = make_train_step(
        create_loss_fn(cfg), clip_grad=cfg.clip_grad,
        nonfinite_guard=cfg.guard_nonfinite == "skip", generator=generator,
        grad_accum=cfg.grad_accum)
    return Run(cfg, device, state, train_step,
               make_eval_step(cross_entropy),
               make_eval_step(cross_entropy, use_ema=True)
               if cfg.model_ema else None,
               train_loader, eval_loader, lr_scheduler, num_epochs)


def build_datasets(cfg: TrainConfig):
    """(train, eval) datasets, as the JAX runner's ``build_datasets``:
    seeded noise clips, or the clip dataset of ``--data`` (through its pack
    with ``--data-packed``), its eval split seeded out of the same roots
    unless ``--eval-data`` names others (read from the frames)."""
    c, h, w = cfg.input_size()
    if cfg.dataset == "synthetic":
        if cfg.data_packed:
            raise ValueError("--data-packed requires --dataset deepfake_v3")
        n = max(cfg.batch_size * 8, 16)
        return (SyntheticDataset(n, (h, w, c), cfg.num_classes, cfg.seed),
                SyntheticDataset(max(n // 2, 8), (h, w, c), cfg.num_classes,
                                 cfg.seed + 1))
    if cfg.dataset != "deepfake_v3":
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if not (cfg.data or cfg.data_packed):
        raise ValueError("--dataset deepfake_v3 needs --data (or "
                         "--data-packed)")
    frames = max(1, c // 3)
    common = dict(frames_per_clip=frames, label_balance=cfg.label_balance,
                  noise_fake=cfg.noise_fake > 0, split_seed=cfg.split_seed)
    if cfg.data_packed:
        def make_train(**kw):
            return PackedDataset(cfg.data_packed, roots=cfg.data or None,
                                 image_size=cfg.pack_image_size or None,
                                 **kw)
    else:
        def make_train(**kw):
            return DeepFakeClipDataset(cfg.data, **kw)
    if cfg.eval_data:
        return (make_train(**common),
                DeepFakeClipDataset(cfg.eval_data, frames_per_clip=frames,
                                    split_seed=cfg.split_seed))
    return (make_train(train_split=True, train_ratio=cfg.train_split,
                       is_training=True, **common),
            make_train(train_split=True, train_ratio=cfg.train_split,
                       is_training=False, frames_per_clip=frames,
                       split_seed=cfg.split_seed))


def build_loaders(cfg: TrainConfig, device, train_ds, eval_ds
                  ) -> Tuple[DeviceLoader, DeviceLoader]:
    """(train, eval) loaders: the clip dataset's with the augment chain
    where ``--augment-device`` puts it (``blur_radius`` 1, as the JAX
    runner passes), or, for the
    synthetic set, collate, host mixup, normalize and erase; the train
    set's AugMix views under ``--aug-splits``; batches in the compute
    dtype (the JAX runner's loader dtype), normalized by
    :meth:`TrainConfig.mean_std`.  The train batch is ``batch_size ×
    grad_accum``; the eval batch ``2 × batch_size``."""
    c, h, w = cfg.input_size()
    mean, std = cfg.mean_std()
    batch = cfg.batch_size * cfg.grad_accum
    mixup = FastCollateMixup(cfg.mixup, cfg.smoothing, cfg.num_classes) \
        if cfg.mixup > 0 else None
    erase = dict(re_prob=cfg.reprob, re_mode=cfg.remode,
                 re_count=cfg.recount, re_split=cfg.resplit,
                 re_max=cfg.remax)
    common = dict(num_workers=cfg.workers, seed=cfg.seed,
                  prefetch_depth=cfg.prefetch_depth,
                  dtype=_DTYPES[cfg.compute_dtype],
                  loader_backend=cfg.loader_backend,
                  ring_depth=cfg.ring_depth,
                  worker_heartbeat=cfg.worker_heartbeat, mean=mean, std=std)
    if cfg.dataset == "synthetic":
        img_num = max(1, c // 3)
        return (create_loader(train_ds, batch, True, device,
                              img_num=img_num, collate_mixup=mixup, **erase,
                              num_aug_splits=cfg.aug_splits, **common),
                create_loader(eval_ds, cfg.batch_size * 2, False, device,
                              img_num=img_num, **common))
    return (create_deepfake_loader_v3(
                train_ds, (c, h, w), batch, is_training=True,
                device=device, color_jitter=cfg.color_jitter,
                collate_mixup=mixup, flicker=cfg.flicker,
                rotate_range=cfg.rotate_range, blur_radius=1,
                blur_prob=cfg.blur_prob,
                device_color_jitter=not cfg.host_color_jitter,
                fused_geom=not cfg.host_geom,
                augment_device=cfg.augment_device == "on",
                num_aug_splits=cfg.aug_splits, **erase, **common),
            create_deepfake_loader_v3(
                eval_ds, (c, h, w), cfg.batch_size * 2, is_training=False,
                device=device, eval_crop=cfg.eval_crop, **common))


def _outdir(cfg: TrainConfig) -> str:
    """The run's directory, made; ``-N`` appended to a name in use, except
    under ``--auto-resume``, which must find its own run again."""
    name = cfg.experiment or "-".join([
        cfg.model_version or cfg.model,
        os.path.basename(cfg.data.split(":")[0]) or cfg.dataset])
    base = os.path.join(cfg.output, name)
    path, i = base, 1
    while os.path.exists(path) and not cfg.auto_resume:
        path, i = f"{base}-{i}", i + 1
    os.makedirs(path, exist_ok=True)
    return path


def _restore_with_fallback(output_dir: str, state: TrainState,
                           load_opt: bool):
    """The resume ladder: recovery snapshots newest first, then the
    ``_bak`` and ``model_best`` copies, skipping corrupt files.  Returns
    ``(meta, path)`` of the one loaded into ``state``, or None."""
    wait_pending_saves()
    for path in find_resume_candidates(
            output_dir, bak_dir=os.path.join(output_dir, "_bak")):
        try:
            return restore_train_state(path, state, load_opt), path
        except (CheckpointCorrupt, FileNotFoundError) as e:
            _logger.warning("auto-resume: skipping unusable checkpoint %s "
                            "(%s)", path, e)
    return None


def _position(meta: Dict[str, Any], num_batches: int) -> Tuple[int, int]:
    """(epoch, batch) to continue from after loading ``meta``'s file: the
    batch after a recovery snapshot's (the next epoch's first after an
    epoch's last), else the epoch after an epoch checkpoint's."""
    if "batch_idx" in meta:
        epoch, batch = int(meta["epoch"]), int(meta["batch_idx"]) + 1
        if batch >= num_batches > 0:
            return epoch + 1, 0
        return epoch, batch
    return int(meta.get("epoch", -1)) + 1, 0


def _observe(cfg: TrainConfig, run: Run, output_dir: str, resilience):
    """``(telemetry, metrics server, profiler)`` of the run, each None
    where it is off: the tracker with its JSONL log in the run dir, its
    collectors and the MFU inputs (the port's forward FLOP count, the
    card's dense bf16 peak)."""
    if cfg.no_telemetry:
        return None, None, None
    from ..obs import (EventLog, ProfilerCapture, TrainTelemetry,
                       forward_flops_per_sample, loader_collector,
                       peak_flops, resilience_collector,
                       start_metrics_server)
    c, h, w = cfg.input_size()
    telemetry = TrainTelemetry(
        event_log=EventLog(os.path.join(output_dir, "telemetry.jsonl")),
        flops_per_sample=forward_flops_per_sample(run.state.model,
                                                  (1, c, h, w)),
        peak_flops=peak_flops(run.device),
        meta=dict(model=cfg.model,
                  global_batch=cfg.batch_size * cfg.grad_accum))
    telemetry.register_collector(loader_collector(run.train_loader))
    telemetry.register_collector(resilience_collector(resilience))
    server = start_metrics_server(telemetry, port=cfg.metrics_port) \
        if cfg.metrics_port else None
    profiler = None
    if cfg.profile_capture > 0:
        profiler = ProfilerCapture(output_dir, num_steps=cfg.profile_capture,
                                   telemetry=telemetry)
        telemetry.profiler = profiler
    return telemetry, server, profiler


def main(cfg: TrainConfig) -> Dict[str, Any]:
    """Train to ``cfg.epochs``; returns the best eval metric and epoch,
    the last eval and train metrics, the train loader's counters
    (``loader``: batches, the train loop's wait for the host and the host
    threads' load + collate seconds), the number of ``rewinds`` and the
    run's output directory.  Raises ``SystemExit(75)`` after a preemption
    stop (the recovery snapshot on disk)."""
    run = setup(cfg)
    state = run.state
    output_dir = _outdir(cfg)
    args = dataclasses.asdict(cfg)
    with open(os.path.join(output_dir, "args.json"), "w") as f:
        json.dump(args, f, indent=2)
    saver = CheckpointSaver(output_dir, decreasing=cfg.eval_metric == "loss",
                            bak_dir=os.path.join(output_dir, "_bak"))
    num_batches = len(run.train_loader)
    start_epoch, resume_batch = cfg.start_epoch or 0, 0
    resumed_from = ""
    if cfg.resume:
        resumed_from = cfg.resume
        meta = restore_train_state(cfg.resume, state, not cfg.no_resume_opt)
        start_epoch = cfg.start_epoch if cfg.start_epoch is not None \
            else int(meta.get("epoch", -1)) + 1
        _logger.info("Resumed from %s (epoch %d)", cfg.resume, start_epoch)
    if cfg.auto_resume:
        # newer than --resume when present: a relaunch continues from its
        # own snapshot, not from the checkpoint that seeded the run
        restored = _restore_with_fallback(output_dir, state,
                                          not cfg.no_resume_opt)
        if restored is not None:
            meta, path = restored
            resumed_from = path
            start_epoch, resume_batch = _position(meta, num_batches)
            _logger.info("Auto-resumed from %s (epoch %d, batch %d)", path,
                         start_epoch, resume_batch)
        else:
            _logger.info("--auto-resume: nothing to resume in %s; starting "
                         "fresh", output_dir)
    if run.lr_scheduler is not None and start_epoch > 0 and \
            resume_batch == 0:
        # an epoch-boundary resume re-derives the LR; a mid-epoch one keeps
        # the snapshot's, which already holds any per-update scheduling
        set_learning_rate(state, run.lr_scheduler.step(start_epoch))
    best_metric = best_epoch = None
    eval_metrics: Dict[str, float] = {}
    train_metrics: Dict[str, Any] = {}
    exit_code: Optional[int] = None
    rewinds = 0
    resilience = Resilience.from_config(cfg, output_dir=output_dir)
    telemetry, obs_server, profiler = _observe(cfg, run, output_dir,
                                               resilience)
    if telemetry is not None:
        telemetry.event("run_start", model=cfg.model, epochs=run.num_epochs,
                        start_epoch=start_epoch,
                        global_batch=cfg.batch_size * cfg.grad_accum,
                        world_size=1,
                        mesh_shape=[1, 1], axis_names=["batch", "model"],
                        device=str(run.device))
        if resumed_from:
            telemetry.event("resume", path=resumed_from, epoch=start_epoch,
                            batch=resume_batch)
    try:
        with resilience:
            if profiler is not None and not profiler.install():
                _logger.warning("not in the main thread: the SIGUSR2 "
                                "profiler trigger is not installed (the "
                                "PROFILE file trigger still works)")
            epoch = start_epoch
            while epoch < run.num_epochs:
                run.train_loader.set_epoch(epoch)
                run.train_loader.fast_forward(resume_batch)
                # a note, not a beat: the first step's warm-up keeps the
                # watchdog's first-window grace
                resilience.note(f"epoch {epoch} start (batch "
                                f"{resume_batch})")
                try:
                    state, train_metrics = train_one_epoch(
                        epoch, run.train_step, state, run.train_loader, cfg,
                        lr_scheduler=run.lr_scheduler, saver=saver,
                        args=args, start_batch=resume_batch,
                        resilience=resilience, telemetry=telemetry)
                except RewindRequested as e:
                    # K bad steps in a row: reload the last snapshot (the
                    # run's own, so with its optimizer) and replay from it
                    resilience.start_rewind(str(e))
                    restored = _restore_with_fallback(output_dir, state,
                                                      True)
                    if restored is None:
                        raise RuntimeError(
                            "rewind requested but no loadable recovery "
                            "snapshot exists: enable --recovery-interval so "
                            "the guard has somewhere to rewind to") from e
                    meta, path = restored
                    rewinds += 1
                    _logger.warning("rewound to %s", path)
                    if telemetry is not None:
                        telemetry.event("rewind", reason=str(e),
                                        restored_from=path)
                    epoch, resume_batch = _position(meta, num_batches)
                    if run.lr_scheduler is not None and resume_batch == 0 \
                            and epoch > 0:
                        set_learning_rate(state,
                                          run.lr_scheduler.step(epoch))
                    continue
                resume_batch = 0
                eval_metrics = validate(run.eval_step, state,
                                        run.eval_loader, cfg,
                                        resilience=resilience)
                if run.eval_step_ema is not None:
                    eval_metrics = validate(run.eval_step_ema, state,
                                            run.eval_loader, cfg,
                                            log_suffix=" (EMA)",
                                            resilience=resilience)
                if run.lr_scheduler is not None:
                    set_learning_rate(state, run.lr_scheduler.step(
                        epoch + 1, eval_metrics[cfg.eval_metric]))
                # the header only when the file is new: a resumed run
                # appends to its own summary
                csv_path = os.path.join(output_dir, "summary.csv")
                update_summary(epoch, {k: v for k, v in train_metrics.items()
                                       if k != "step_s"}, eval_metrics,
                               csv_path, os.path.join(output_dir, "plots"),
                               write_header=not os.path.exists(csv_path))
                best_metric, best_epoch = saver.save_checkpoint(
                    state, args, epoch, metric=eval_metrics[cfg.eval_metric])
                if telemetry is not None:
                    telemetry.event("epoch_end", epoch=epoch, train={
                        k: v for k, v in train_metrics.items()
                        if k != "step_s"}, eval=dict(eval_metrics))
                resilience.heartbeat(f"epoch {epoch} done")
                epoch += 1
    except Preempted as e:
        # the snapshot is on disk: exit with the code the restart wrapper
        # (scripts/train_torch.sh) relaunches into --auto-resume on
        _logger.warning("%s; exiting with code %d", e, EXIT_PREEMPTED)
        exit_code = EXIT_PREEMPTED
        if telemetry is not None:
            telemetry.event("preempted", epoch=e.epoch, batch=e.batch_idx,
                            signum=e.signum)
    finally:
        # the shm transport owns worker processes and a shared-memory
        # segment: release them on every exit path (threads: a no-op),
        # before the newest snapshot's write is flushed
        run.train_loader.close()
        run.eval_loader.close()
        wait_pending_saves()
        if profiler is not None:
            profiler.close()            # stops a live trace, restores SIGUSR2
        if obs_server is not None:
            obs_server.shutdown()
            obs_server.server_close()
        if telemetry is not None:
            telemetry.event("run_end", exit_code=exit_code,
                            best_metric=best_metric, best_epoch=best_epoch)
            telemetry.close()
    if exit_code is not None:
        raise SystemExit(exit_code)
    if best_metric is not None:
        _logger.info("*** Best metric: %s (epoch %s)", best_metric,
                     best_epoch)
    return {"best_metric": best_metric, "best_epoch": best_epoch,
            "eval": dict(eval_metrics), "train": dict(train_metrics),
            "loader": {"batches": run.train_loader.stats.batches,
                       "host_wait_s": run.train_loader.stats.host_wait_s,
                       "fetch_s": run.train_loader.loader.stats.fetch_s},
            "rewinds": rewinds, "output_dir": output_dir}


def launch_main(argv=None) -> Dict[str, Any]:
    """CLI entry: parse, log to stderr, train."""
    cfg = parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    return main(cfg)


if __name__ == "__main__":
    launch_main(sys.argv[1:])
