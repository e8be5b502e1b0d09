"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failure raises and exits non-zero
before the result line:

1. device: the card's ``nvidia-smi`` name and power limit, torch and CUDA;
2. build: ``nvcc`` compiles every kernel source of the port (the three
   depthwise and the three flash-attention kernels), one process per
   source, all started together (timed, with ptxas' register report); for
   every instantiation of the depthwise forward and dx kernels, ptxas'
   registers and spills, and the card's registers, local bytes, largest
   dynamic shared memory and resident blocks per SM;
3. forward kernel vs plain: the depthwise kernel at every depthwise shape
   of the flagship ``efficientnet_deepfake_v4`` at a 600² input (batch 1,
   the inference path's, and batch 2; f32, TF32 off), bf16 on a few of them,
   and edge cases (C = 13, odd H/W, ``'same'`` and int padding, act
   none/relu, identity affine, an unaligned base pointer), each against its
   plain PyTorch version on the same inputs, two calls bitwise equal; the
   device time of the kernel,
   the plain version and the library call (a CUDA graph of 20 calls
   replayed between CUDA events), beside the bound (bytes over the memory
   rate or operations over the f32 rate);
4. dw-gradient kernel vs plain: the same shapes at the training batch (3),
   f32, bf16 x on a few, and edge cases; two calls must give bitwise-equal
   dw; kernel, plain, library (cuDNN's weight gradient) and bound times,
   and each stage's workspace bytes and the kernels one call launches
   (counted by torch.profiler);
5. dx kernel and backward vs plain: the dx kernel (``depthwise_dx``, a
   direct transposed kernel, no dilated copy) against
   ``depthwise_dx_reference`` at every flagship shape at batch 3 and at
   edge cases (padding k and k+1 a side, C = 13 with odd H/W at k5 s2, bf16
   dx, an unaligned base), two calls bitwise equal, with its device time
   beside the plain version's, cuDNN's input gradient and the bound; then,
   for the identity epilogue (the training call) and for affine + SiLU (the
   path that saves z), the forward the training path launches (y against
   the plain version, elementwise) and the full ``fused_depthwise`` backward
   on the card (dx and dw through their kernels) against
   ``torch.autograd`` through the plain version, also at a padding of k and
   k+1 a side;
6. flash kernels vs plain: forward, dQ and dK/dV at the TimeSformer's
   spatial attention (B·H 384 for a train step at batch 8, 768 for an eval
   forward at batch 16; L 576, D 64, f32) and at edge cases (L 197 and 200,
   D 32, 48 and 128 (at L 130 and 576), key padding, causal with offsets,
   rows that see no key, bf16): O, lse and the gradients against the plain
   versions, two forward and two backward calls bitwise equal; device
   times of kernel, plain, SDPA pinned to its memory-efficient backend
   (library; its backward timed alone on the device, as the port's autograd
   backward), and both bounds (f32 SIMT and three TF32 products on the
   tensor cores); the three kernels' registers, spills, shared memory,
   resident blocks per SM and SASS HMMA count (every instantiation must have
   HMMA); ``flash_attention`` forward and backward on the card against
   ``torch.autograd`` through the plain forward;
7. inference path: the flagship at full width and depth (12×600², 55
   blocks) with seeded weights and BN calibrated on the CPU by one
   train-mode pass over the inputs at 600², scoring seeded frames of mixed
   aspect ratios through ``runners.test.test_img`` on the card, single and
   ``--clip``; 55 forward-kernel launches per forward, scores finite, not
   all 0.5, and matching the same weights run on the CPU (plain path); then
   clips/s at batch 1 and 8, and the device time by kernel kind at batch 8
   (torch.profiler);
8. training path: ``runners.train`` in-process on the flagship at full width
   and depth, 12×600², batch 3 (``scripts/train.sh``'s config on synthetic
   data: 8 steps, validation of the model and its EMA, checkpoints); 55
   forward, 55 dx and 55 dw-gradient launches per step; loss finite; params, BN stats and EMA moved; the inference
   path scores a frame with the checkpoint; ms per step, samples/s, peak
   memory, and the device time per step by kernel kind;
9. TimeSformer training path: ``runners.train`` in-process on
   ``timesformer_base_patch25_600`` (full width and depth) at 12×600²,
   batch 8, ``--attn-impl flash``: 8 steps, validation of the model and its
   EMA, a checkpoint; 12 forward, 12 dQ and 12 dK/dV launches a step and 12
   forward launches an eval forward; loss finite, params and EMA moved; the
   EMA reloaded from the checkpoint scores the eval set as the run did; ms
   per step, samples/s, peak memory, the device time per step by kernel kind
   and the eval forward's clips/s at batch 16;
10. card against CPU: one guarded train step of the full flagship at
   12×224², batch 2, and of the full TimeSformer at 12×300², batch 2, from
   the same weights on the card and on the CPU (loss, every parameter's
   update, BN running stats); then a NaN batch through each card step must
   leave the whole state bitwise unchanged;
11. the ``kernels`` line (all six kernels), the ``nvidia-smi`` line, and
   last ``{"ok": true, "device": {...}}``.

Without CUDA, or in a directory that holds only this file, it exits
non-zero and prints no result.  Its files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import ctypes
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

from deepfake_detection_tpu_torch import losses
from deepfake_detection_tpu_torch.csrc.build import build, kernel
from deepfake_detection_tpu_torch.models import (create_deepfake_model_v4,
                                                 create_model)
from deepfake_detection_tpu_torch.ops import depthwise as dw
from deepfake_detection_tpu_torch.ops import flash_attention as fa
from deepfake_detection_tpu_torch.ops.conv import explicit_padding
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import test as runner
from deepfake_detection_tpu_torch.runners import train as train_runner
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from deepfake_detection_tpu_torch.train.trainer import validate
from flash_bench import FLAGSHIP_DW, TRAIN_BATCH, device_ms

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# H100 SXM data-sheet peaks
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12          # dense tensor cores; f32 as 3 TF32 products
EPS32 = float(np.finfo(np.float32).eps)

MAIN_BATCH = 1                    # test_img: one image or clip a forward
KERNEL_BATCHES = (MAIN_BATCH, 2)  # batches of the kernel-vs-plain rows

F32_TOL = (1e-5, 1e-5)            # |kernel - plain| ≤ atol + rtol·|plain|
BF16_TOL = (1e-6, 2.0 ** -7)      # one bf16 rounding apart, 2^-8 relative
SCORE_TOL = 1e-3                  # P(fake), card vs CPU, f32 over 55 blocks
# gradients (dw, dx, dscale, dbias) are sums of up to 270k products taken in
# other orders than the plain version's: |kernel - plain| ≤ GRAD_TOL ·
# max|plain| per tensor (1.1e-6 measured); a bf16 dx is one bf16 rounding
GRAD_TOL = 1e-5
BF16_GRAD_TOL = 2.0 ** -7
LOSS_TOL = 1e-4                   # card vs CPU train step, relative
UPDATE_TOL = 1e-3                 # of each parameter update's own max |·|

# scripts/train.sh's flags that the port has, on synthetic data, one epoch
# (24 samples: 8 steps); --log-interval 1 reads each step's metrics back,
# so each step's host time is its device time
TRAIN_FLAGS = ["--dataset", "synthetic", "--model", "efficientnet_deepfake_v4",
               "--model-version", "v4", "--input-size-v2", "12,600,600",
               "-b", str(TRAIN_BATCH), "--opt", "rmsproptf", "--basic-lr",
               "5e-7", "--sched", "step", "--decay-epochs", "2",
               "--decay-rate", ".92", "--bn-momentum", "0.001", "--mixup",
               "0.1", "--model-ema", "--epochs", "1", "--log-interval", "1"]


# the TimeSformer's training path: timesformer_base_patch25_600 on the
# flagship's 12×600² clips (4 frames, 576 patches of 25² each), batch 8, the
# flash kernels for the spatial attention of its 12 blocks; 64 synthetic
# clips make 8 steps, 32 eval clips 2 eval batches of 16
TSF_MODEL = "timesformer_base_patch25_600"
TSF_BATCH = 8
TSF_BLOCKS = 12
TSF_FLAGS = ["--dataset", "synthetic", "--model", TSF_MODEL,
             "--model-version", "", "--input-size-v2", "12,600,600",
             "--attn-impl", "flash", "-b", str(TSF_BATCH), "--opt",
             "rmsproptf", "--model-ema", "--epochs", "1", "--log-interval",
             "1"]
# (B·frames·heads) of the spatial attention: a train step at batch 8 and an
# eval forward at batch 16; 576 tokens a frame, head dim 64
FLASH_BH = (TSF_BATCH * 4 * 12, 2 * TSF_BATCH * 4 * 12)
FLASH_L, FLASH_D = 576, 64
# kernel vs plain, f32: o and lse elementwise within atol + rtol·|plain|
# (sums of 576 products in another order, online rescaling against one
# softmax); gradients within FLASH_GRAD_TOL of each gradient's max |plain|
# (the backward kernels take every product as three TF32 products, the
# plain version as one f32 matmul)
FLASH_TOL = (2e-5, 2e-5)
FLASH_GRAD_TOL = 1e-5


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn()`` issued back to back, CUDA events around the
    run: where the host issues slower than the device runs, this is the
    host's rate."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_dw_shapes(model, size: int) -> Counter:
    """(H in, C, k, stride) of every depthwise stage for a ``size``² input,
    walked from the model's own blocks."""
    stem = model.conv_stem
    t, b, _, _ = explicit_padding(stem.padding, stem.kernel_size, 1,
                                  stem.stride, size, size)
    h = (size + t + b - 3) // stem.stride[0] + 1
    shapes = Counter()
    for stage in model.blocks:
        for block in stage:
            conv = block.conv_dw
            k, s = conv.kernel_size[0], conv.stride[0]
            shapes[(h, conv.weight.shape[0], k, s)] += 1
            pads = explicit_padding(block.pad_type, (k, k), 1, s, h, h)
            h = dw.output_size(h, h, k, s, pads)[0]
    return shapes


def _case(shape, k, dtype, seed, identity=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    w = torch.randn((k, k, c), generator=g, device="cuda") * 0.2
    if identity:
        return x, w, None, None
    scale = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = (torch.rand(c, generator=g, device="cuda") - 0.5) * 0.4
    return x, w, scale, bias


def check(name, x, w, scale, bias, stride, padding, act, tol) -> float:
    """Kernel vs plain y elementwise within ``tol``; two kernel calls must
    agree bitwise.  Returns the max absolute error."""
    y = dw.fused_depthwise(x, w, scale, bias, stride, padding, act)
    again = dw.fused_depthwise(x, w, scale, bias, stride, padding, act)
    ref = dw.fused_depthwise_reference(x, w, scale, bias, stride, padding,
                                       act)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        raise AssertionError(f"{name}: two forward calls differ")
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise AssertionError(f"{name}: {y.shape} {y.dtype} vs plain "
                             f"{ref.shape} {ref.dtype}")
    diff = (y.float() - ref.float()).abs()
    bound = tol[0] + tol[1] * ref.float().abs()
    if not torch.isfinite(y).all() or bool((diff > bound).any()):
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{diff.max().item():.3e} over atol {tol[0]} + "
                             f"rtol {tol[1]}")
    return diff.max().item()


def stage_cost(b, h, c, k, s, itemsize):
    """Bytes the stage must move (x read once, y written once, w, scale,
    bias) and its operations (k² multiply-adds + affine + SiLU per
    output)."""
    ho = (h + 2 * (((s - 1) + (k - 1)) // 2) - k) // s + 1
    nbytes = (b * h * h * c + b * ho * ho * c) * itemsize + (k * k + 2) * c * 4
    ops = b * ho * ho * c * (2 * k * k + 6)
    return nbytes, ops


def phase_kernels(shapes: Counter) -> dict:
    """Kernel vs plain at every flagship depthwise shape, at the main path's
    batch (``runners.test.test_img`` scores one image or clip per forward)
    and at batch 2; returns the totals per batch over the 55 stages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = 0.0
    totals = {}
    for batch in KERNEL_BATCHES:
        tot = totals[batch] = dict(ms=0.0, call_ms=0.0, plain_ms=0.0,
                                   library_ms=0.0, bound_ms=0.0,
                                   bytes_ms=0.0, ops_ms=0.0)
        for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
            x, w, scale, bias = _case((batch, h, h, c), k, torch.float32,
                                      100 * batch + i)
            err = check(f"f32 b{batch} {h}x{h}x{c} k{k} s{s}", x, w, scale,
                        bias, s, "", "silu", F32_TOL)
            max_err = max(max_err, err)
            xc = x.permute(0, 3, 1, 2)
            w_lib = (w * scale).permute(2, 0, 1).unsqueeze(1).contiguous()
            p = ((s - 1) + (k - 1)) // 2

            def kernel():
                return dw.fused_depthwise(x, w, scale, bias, s, "", "silu")
            ms = device_ms(kernel)
            per_call = call_ms(kernel)
            plain = device_ms(lambda: dw.fused_depthwise_reference(
                x, w, scale, bias, s, "", "silu"))
            lib = device_ms(lambda: F.silu(F.conv2d(xc, w_lib, bias, s, p, 1,
                                                    c)))
            nbytes, ops = stage_cost(batch, h, c, k, s, 4)
            b_ms = nbytes / MEM_BYTES_PER_S * 1e3
            o_ms = ops / F32_FLOP_PER_S * 1e3
            row = dict(h=h, c=c, k=k, stride=s, count=count, batch=batch,
                       max_abs_err=err, ms=ms, call_ms=per_call,
                       plain_ms=plain, library_ms=lib,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations",
                       bound_share=max(b_ms, o_ms) / ms,
                       gbytes_per_s=nbytes / ms / 1e6)
            emit(phase="kernel_row", **row)
            for key, v in (("ms", ms), ("call_ms", per_call),
                           ("plain_ms", plain), ("library_ms", lib),
                           ("bound_ms", row["bound_ms"]), ("bytes_ms", b_ms),
                           ("ops_ms", o_ms)):
                tot[key] += count * v
    # bf16 on a few flagship rows, then the edge cases
    bf16 = [(300, 256, 3, 1), (150, 288, 5, 2), (19, 3840, 3, 1)]
    for j, (h, c, k, s) in enumerate(bf16):
        x, w, scale, bias = _case((2, h, h, c), k, torch.bfloat16, 100 + j)
        check(f"bf16 {h}x{h}x{c} k{k} s{s}", x, w, scale, bias, s, "",
              "silu", BF16_TOL)
    edges = [("C=13 odd H/W k3 s1", (2, 37, 29, 13), 3, 1, "", "silu"),
             ("C=13 k5 s2 same", (2, 36, 36, 13), 5, 2, "same", "relu"),
             ("odd H/W k5 s2 int pad", (3, 31, 45, 24), 5, 2, 1, "none"),
             ("same pad k3 s2 even", (2, 40, 40, 64), 3, 2, "same", "silu"),
             ("relu k3 s1", (2, 17, 17, 96), 3, 1, "", "relu")]
    for j, (name, shape, k, s, pad, act) in enumerate(edges):
        x, w, scale, bias = _case(shape, k, torch.float32, 200 + j)
        max_err = max(max_err, check(name, x, w, scale, bias, s, pad, act,
                                     F32_TOL))
    x, w, _, _ = _case((2, 23, 23, 40), 3, torch.float32, 300, identity=True)
    max_err = max(max_err, check("identity affine", x, w, None, None, 1, "",
                                 "none", F32_TOL))
    # contiguous but only 4-byte aligned: the kernel's scalar path
    flat = torch.randn(1 + 19 * 19 * 48, device="cuda")
    x = flat[1:].view(1, 19, 19, 48)
    w = torch.randn(3, 3, 48, device="cuda") * 0.2
    max_err = max(max_err, check("unaligned base", x, w, None, None, 1, "",
                                 "silu", F32_TOL))
    xb, wb, _, _ = _case((2, 15, 15, 13), 3, torch.bfloat16, 400, True)
    check("bf16 C=13", xb, wb, None, None, 2, "same", "silu", BF16_TOL)
    for batch, tot in totals.items():
        emit(phase="kernels", batch=batch, rows=len(shapes),
             stages=sum(shapes.values()), max_abs_err=max_err, **tot)
    return dict(max_abs_err=max_err, **totals[MAIN_BATCH])


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _grad_case(shape, k, s, pad, dtype, seed):
    """x (NHWC, ``dtype``), its pads, and an f32 upstream gradient dz of
    the stage's output shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pads = explicit_padding(pad, (k, k), 1, s, shape[1], shape[2])
    ho, wo = dw.output_size(shape[1], shape[2], k, s, pads)
    dz = torch.randn((shape[0], ho, wo, shape[3]), generator=g, device="cuda")
    return x, dz, pads


def check_dwgrad(name, x, dz, k, s, pads) -> float:
    """Kernel vs plain dw; two kernel calls must agree bitwise.  Returns
    the max absolute error."""
    a = dw.depthwise_dwgrad(x, dz, k, s, pads)
    b = dw.depthwise_dwgrad(x, dz, k, s, pads)
    ref = dw.depthwise_dwgrad_reference(x, dz, k, s, pads)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two dw-gradient calls differ")
    rel = _rel_err(a, ref)
    if not torch.isfinite(a).all() or rel > GRAD_TOL:
        raise AssertionError(f"{name}: dw |kernel - plain| / max|plain| "
                             f"{rel:.3e} > {GRAD_TOL}")
    return (a - ref).abs().max().item()


def _device_kernels(fn) -> Counter:
    """Launches of each kernel in one ``fn()`` on the card, by name
    (torch.profiler); empty where the profiler sees no device activity."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})


def phase_dwgrad(shapes: Counter) -> dict:
    """The dw-gradient kernel against its plain version at every flagship
    depthwise shape at the training batch, bf16 x on a few, edge cases;
    each stage's row also gives its workspace bytes and kernel launches a
    call; returns the count-weighted sums over the 55 stages."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, workspace_bytes=0)
    max_err = 0.0
    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "",
                                 torch.float32, 500 + i)
        err = check_dwgrad(f"f32 {h}x{h}x{c} k{k} s{s}", x, dz, k, s, pads)
        max_err = max(max_err, err)
        xc, dzc = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
        ms = device_ms(lambda: dw.depthwise_dwgrad(x, dz, k, s, pads))
        plain = device_ms(lambda: dw.depthwise_dwgrad_reference(
            x, dz, k, s, pads))
        lib = device_ms(lambda: torch.nn.grad.conv2d_weight(
            xc, (c, 1, k, k), dzc, s, pads[0], 1, c))
        nbytes = (x.numel() + dz.numel() + k * k * c) * 4
        ops = 2 * k * k * dz.numel()
        b_ms = nbytes / MEM_BYTES_PER_S * 1e3
        o_ms = ops / F32_FLOP_PER_S * 1e3
        # the workspace of per-tile partials, and the kernels one call
        # launches as the profiler sees them
        ws = 4 * dw._fn("depthwise_dwgrad", "dfd_depthwise_dwgrad_workspace")(
            TRAIN_BATCH, dz.shape[1], dz.shape[2], c, k)
        launched = _device_kernels(
            lambda: dw.depthwise_dwgrad(x, dz, k, s, pads))
        emit(phase="dwgrad_row", h=h, c=c, k=k, stride=s, count=count,
             batch=TRAIN_BATCH, max_abs_err=err, ms=ms, plain_ms=plain,
             library_ms=lib, bound_ms=max(b_ms, o_ms),
             bound_by="bytes" if b_ms >= o_ms else "operations",
             gbytes_per_s=nbytes / ms / 1e6, workspace_bytes=ws,
             kernel_launches_per_call=sum(launched.values()) or
             "not measured", bound_share=max(b_ms, o_ms) / ms)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", max(b_ms, o_ms)), ("bytes_ms", b_ms),
                       ("ops_ms", o_ms), ("workspace_bytes", ws)):
            tot[key] += count * v
    for j, (h, c, k, s) in enumerate([(300, 256, 3, 1), (150, 288, 5, 2),
                                      (19, 3840, 3, 1)]):
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "",
                                 torch.bfloat16, 550 + j)
        check_dwgrad(f"bf16 x {h}x{h}x{c} k{k} s{s}", x, dz, k, s, pads)
    edges = [("C=13 odd H/W k3 s1", (3, 37, 29, 13), 3, 1, ""),
             ("C=13 k5 s2 same", (3, 36, 36, 13), 5, 2, "same"),
             ("odd H/W k5 s2 int pad", (3, 31, 45, 24), 5, 2, 1),
             ("same pad k3 s2 even", (3, 40, 40, 64), 3, 2, "same"),
             ("C=13 bf16 k3 s2 same", (3, 15, 15, 13), 3, 2, "same"),
             ("one tile B=1 k5 s1", (1, 7, 9, 13), 5, 1, "")]
    for j, (name, shape, k, s, pad) in enumerate(edges):
        dtype = torch.bfloat16 if "bf16" in name else torch.float32
        x, dz, pads = _grad_case(shape, k, s, pad, dtype, 560 + j)
        max_err = max(max_err, check_dwgrad(name, x, dz, k, s, pads))
    emit(phase="dwgrad", batch=TRAIN_BATCH, rows=len(shapes),
         stages=sum(shapes.values()), max_abs_err=max_err, bitwise=True,
         **tot)
    return dict(max_abs_err=max_err, **tot)


def check_backward(name, shape, k, s, pad, affine, dtype, seed):
    """``fused_depthwise`` on the card with a gradient wanted (the autograd
    node's forward, which writes z for the affine + SiLU epilogue) vs the
    plain version: y elementwise at F32_TOL (BF16_TOL for bf16 x), then dx,
    dw and, with the affine epilogue, dscale and dbias against autograd.
    Returns (y's max absolute error, the gradients' largest relative
    error)."""
    x, w, scale, bias = _case(shape, k, dtype, seed, identity=not affine)
    act = "silu" if affine else "none"
    worst = 0.0
    ys, grads = [], []
    for fn in (dw.fused_depthwise, dw.fused_depthwise_reference):
        ins = [t.clone().requires_grad_() for t in (x, w, scale, bias)
               if t is not None]
        y = fn(*ins[:2], *(ins[2:] or [None, None]), s, pad, act)
        gy = torch.randn(y.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed + 1)).to(y.dtype)
        grads.append(torch.autograd.grad(y, ins, gy))
        ys.append(y.detach())
    torch.cuda.synchronize()
    got, want = ys
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    diff = (got.float() - want.float()).abs()
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.isfinite(got).all()
            or bool((diff > tol[0] + tol[1] * want.float().abs()).any())):
        raise AssertionError(f"{name}: y {got.shape} {got.dtype}, max "
                             f"|kernel - plain| {diff.max().item():.3e} over "
                             f"atol {tol[0]} + rtol {tol[1]}")
    y_err = diff.max().item()
    for label, got, want in zip(("dx", "dw", "dscale", "dbias"), *grads):
        rel = _rel_err(got, want)
        tol = BF16_GRAD_TOL if label == "dx" and dtype == torch.bfloat16 \
            else GRAD_TOL
        if not torch.isfinite(got).all() or rel > tol:
            raise AssertionError(f"{name}: {label} |card - autograd| / "
                                 f"max|autograd| {rel:.3e} > {tol}")
        worst = max(worst, rel)
    return y_err, worst


def check_dx(name, dz, w, x_shape, s, pads, dtype) -> float:
    """The dx kernel vs its plain version: within GRAD_TOL of dx's max
    |plain| (BF16_GRAD_TOL for a bf16 dx, one rounding apart); two calls
    must agree bitwise.  Returns the error relative to max |plain| and the
    max absolute error."""
    a = dw.depthwise_dx(dz, w, x_shape, s, pads, dtype)
    b = dw.depthwise_dx(dz, w, x_shape, s, pads, dtype)
    ref = dw.depthwise_dx_reference(dz, w, x_shape, s, pads, dtype)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two dx calls differ")
    if a.shape != ref.shape or a.dtype != ref.dtype:
        raise AssertionError(f"{name}: dx {a.shape} {a.dtype} vs plain "
                             f"{ref.shape} {ref.dtype}")
    rel = _rel_err(a, ref)
    tol = BF16_GRAD_TOL if dtype == torch.bfloat16 else GRAD_TOL
    if not torch.isfinite(a).all() or rel > tol:
        raise AssertionError(f"{name}: dx |kernel - plain| / max|plain| "
                             f"{rel:.3e} > {tol}")
    return rel, (a.float() - ref.float()).abs().max().item()


def phase_dx(shapes: Counter) -> dict:
    """The dx kernel against its plain version at every flagship depthwise
    shape at the training batch and at edge cases; its device time beside
    the plain version's, cuDNN's input gradient and the bound; returns the
    count-weighted sums over the 55 stages and the largest error."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    worst = worst_abs = 0.0
    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "",
                                 torch.float32, 750 + i)
        w = torch.randn((k, k, c), device="cuda") * 0.2
        shape = tuple(x.shape)
        err, abs_err = check_dx(f"f32 {h}x{h}x{c} k{k} s{s}", dz, w, shape,
                                s, pads, torch.float32)
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
        ms = device_ms(lambda: dw.depthwise_dx(dz, w, shape, s, pads,
                                               torch.float32))
        plain = device_ms(lambda: dw.depthwise_dx_reference(
            dz, w, shape, s, pads, torch.float32))
        w_lib = w.permute(2, 0, 1).unsqueeze(1).contiguous()
        dzc = dz.permute(0, 3, 1, 2)
        lib = device_ms(lambda: torch.nn.grad.conv2d_input(
            (TRAIN_BATCH, c, h, h), w_lib, dzc, s, pads[0], 1, c))
        nbytes = (dz.numel() + x.numel() + k * k * c) * 4
        b_ms = nbytes / MEM_BYTES_PER_S * 1e3
        o_ms = 2 * k * k * dz.numel() / F32_FLOP_PER_S * 1e3
        emit(phase="dx_row", h=h, c=c, k=k, stride=s, count=count,
             batch=TRAIN_BATCH, max_rel_err=err, ms=ms, plain_ms=plain,
             library_ms=lib, bound_ms=max(b_ms, o_ms),
             bound_by="bytes" if b_ms >= o_ms else "operations",
             bound_share=max(b_ms, o_ms) / ms,
             gbytes_per_s=nbytes / ms / 1e6)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", max(b_ms, o_ms)), ("bytes_ms", b_ms),
                       ("ops_ms", o_ms)):
            tot[key] += count * v
    edges = [("padding k at k=3", (3, 17, 17, 24), 3, 1, 3, torch.float32),
             ("padding k+1 at k=5, stride 2", (3, 19, 21, 24), 5, 2, 6,
              torch.float32),
             ("C=13 odd H/W k5 s2", (3, 31, 45, 13), 5, 2, 1, torch.float32),
             ("C=13 odd H/W k3 s1 same", (3, 37, 29, 13), 3, 1, "same",
              torch.float32),
             ("bf16 dx k3 s2 same", (3, 40, 40, 64), 3, 2, "same",
              torch.bfloat16),
             ("bf16 dx C=13 k5 s1", (3, 15, 15, 13), 5, 1, "",
              torch.bfloat16)]
    for j, (name, shape, k, s, pad, dtype) in enumerate(edges):
        _, dz, pads = _grad_case(shape, k, s, pad, torch.float32, 770 + j)
        w = torch.randn((k, k, shape[3]), device="cuda") * 0.2
        err, abs_err = check_dx(name, dz, w, shape, s, pads, dtype)
        worst = max(worst, err)
        if dtype == torch.float32:
            worst_abs = max(worst_abs, abs_err)
    # contiguous but only 4-byte aligned: the kernel's scalar path
    flat = torch.randn(1 + 19 * 19 * 48, device="cuda")
    w = torch.randn(3, 3, 48, device="cuda") * 0.2
    err, abs_err = check_dx("unaligned base", flat[1:].view(1, 19, 19, 48),
                            w, (1, 19, 19, 48), 1, (1, 1, 1, 1),
                            torch.float32)
    worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
    emit(phase="dx", batch=TRAIN_BATCH, rows=len(shapes),
         stages=sum(shapes.values()), max_rel_err=worst,
         max_abs_err=worst_abs, bitwise=True, **tot)
    return dict(max_rel_err=worst, max_abs_err=worst_abs, **tot)


def phase_backward(shapes: Counter) -> dict:
    """The forward with a gradient wanted and the full backward against the
    plain version at every flagship shape at the training batch, identity
    and affine + SiLU epilogues, and at paddings beyond k-1; returns the
    gradients' largest relative error and the forward's max absolute
    error."""
    worst = y_worst = 0.0
    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        shape = (TRAIN_BATCH, h, h, c)
        y_err = row_err = 0.0
        for affine in (False, True):
            ye, ge = check_backward(
                f"{h}x{h}x{c} k{k} s{s} {'affine+silu' if affine else 'id'}",
                shape, k, s, "", affine, torch.float32, 700 + 2 * i)
            y_err, row_err = max(y_err, ye), max(row_err, ge)
        worst, y_worst = max(worst, row_err), max(y_worst, y_err)
        emit(phase="backward_row", h=h, c=c, k=k, stride=s, count=count,
             batch=TRAIN_BATCH, max_rel_err=row_err, y_max_abs_err=y_err)
    worst = max(worst, check_backward("bf16 x k3 s2 same", (3, 40, 40, 64), 3,
                                      2, "same", True, torch.bfloat16,
                                      790)[1])
    ye, ge = check_backward("C=13 odd H/W k5 s2 int pad", (3, 31, 45, 13), 5,
                            2, 1, True, torch.float32, 792)
    worst, y_worst = max(worst, ge), max(y_worst, ye)
    # padding beyond k-1 (k and k+1 a side): dx at x's size with no crop
    for j, (name, shape, kk, s, pad, affine) in enumerate([
            ("padding k at k=3", (3, 17, 17, 24), 3, 1, 3, True),
            ("padding k+1 at k=5, stride 2", (3, 19, 21, 24), 5, 2, 6,
             False)]):
        ye, ge = check_backward(name, shape, kk, s, pad, affine,
                                torch.float32, 796 + 2 * j)
        worst, y_worst = max(worst, ge), max(y_worst, ye)
    emit(phase="backward", batch=TRAIN_BATCH, rows=len(shapes),
         max_rel_err=worst, y_max_abs_err=y_worst)
    return dict(max_rel_err=worst, y_max_abs_err=y_worst)


def _frames(rng):
    """Seeded uint8 frames of mixed aspect ratios: smooth content + noise."""
    out = []
    for i, (h, w) in enumerate([(720, 1280), (1080, 1920), (480, 360),
                                (600, 600), (1000, 750), (256, 320),
                                (900, 1600), (640, 480)]):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx[..., None] / (40 + 7 * i)
                                  + yy[..., None] / 53 + np.arange(3) * i)
        out.append(np.clip(base + rng.normal(0, 20, (h, w, 3)), 0,
                           255).astype(np.uint8))
    return out


def phase_main_path(device: str = "cuda", size: int = 600):
    """The inference path; returns its forward-kernel launches and one of
    the frame files it scored."""
    OUT.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    files = []
    for i, img in enumerate(_frames(rng)):
        path = OUT / f"frame{i}.npy"
        np.save(path, img)
        files.append(str(path))
    # seeded flagship; BN calibrated on the CPU by one train-mode pass over
    # the inputs it will score, single and clip (running := the batch's).
    # At the scoring canvas: stats from a small canvas do not fit 600²
    # activations, and the logits then saturate P(fake) at 0 or 1, where
    # any two paths agree.
    t0 = time.perf_counter()
    model = create_deepfake_model_v4(bn_momentum=1.0, device="cpu", seed=0)
    calib = np.concatenate(
        [runner.preprocess(f, size) for f in files]
        + [runner.preprocess_clip(files[i:i + 4], size)
           for i in range(0, len(files), 4)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(calib).permute(0, 3, 1, 2))
    ckpt = OUT / "flagship.pth"
    torch.save(model.state_dict(), ckpt)
    emit(phase="calibrate", s=time.perf_counter() - t0,
         calib_batch=list(calib.shape))
    del model, calib

    launches = 0
    results = {}
    for clip in (False, True):
        forwards = len(files) // (4 if clip else 1)
        dw.fused_depthwise.launches = 0
        t0 = time.perf_counter()
        gpu = np.asarray(runner.test_img(str(ckpt), files, size=size,
                                         clip=clip, device=device))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        counted = dw.fused_depthwise.launches
        if counted != 55 * forwards:
            raise AssertionError(f"clip={clip}: {counted} depthwise launches "
                                 f"for {forwards} forwards, expected "
                                 f"{55 * forwards}")
        launches += counted
        t0 = time.perf_counter()
        cpu = np.asarray(runner.test_img(str(ckpt), files, size=size,
                                         clip=clip, device="cpu"))
        cpu_s = time.perf_counter() - t0
        diff = float(np.abs(gpu - cpu).max())
        if not np.all(np.isfinite(gpu)) or gpu.shape != (forwards,):
            raise AssertionError(f"clip={clip}: bad scores {gpu}")
        if np.abs(gpu - 0.5).max() <= 1e-3:
            raise AssertionError(f"clip={clip}: degenerate scores {gpu}")
        if diff > SCORE_TOL:
            raise AssertionError(f"clip={clip}: card vs CPU P(fake) differ "
                                 f"by {diff:.3e} > {SCORE_TOL}")
        results["clip" if clip else "single"] = gpu.tolist()
        emit(phase="main_path", clip=clip, forwards=forwards,
             launches=counted, p_fake_gpu=gpu.tolist(),
             p_fake_cpu=cpu.tolist(), max_abs_diff=diff, tol=SCORE_TOL,
             gpu_s=gpu_s, cpu_s=cpu_s)

    model = create_deepfake_model_v4(device=device, seed=0)
    model.load_state_dict(torch.load(ckpt, weights_only=True))
    for batch in (1, 8):
        x = torch.randn(batch, 12, size, size, device=device).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            for _ in range(2):
                model(x)
            torch.cuda.synchronize()
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        emit(phase="throughput", batch=batch, clips_per_s=batch * iters / dt,
             ms_per_clip=dt / (batch * iters) * 1e3,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    phase_profile(model, x)
    return launches, files[0]


def _kernel_kind(name: str) -> str:
    n = name.lower()
    for kind in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kind + "_kernel" in n:
            return kind
    if "layer_norm" in n or "gammabeta" in n:
        return "layer_norm"
    if "softmax" in n:
        return "softmax"
    if "dw_fwd_kernel" in n:
        return "depthwise_fwd"
    if "dw_dx_kernel" in n:
        return "depthwise_dx"
    if "dwgrad" in n:
        return "depthwise_dwgrad"
    if "multi_tensor_apply" in n:
        return "foreach (optimizer, EMA, guard copy)"
    if any(t in n for t in ("conv", "cudnn", "gemm", "xmma", "implicit",
                            "sm90", "cutlass", "dgrad", "wgrad")):
        return "conv_gemm"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def _emit_kinds(phase: str, prof, n: int, wall_us: float, **extra) -> None:
    """Device time and launches per iteration by kernel kind, and the
    device's idle share of the wall time, from a torch.profiler run of
    ``n`` iterations."""
    kinds = Counter()
    launches = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kinds[_kernel_kind(e.key)] += e.self_device_time_total
            launches[_kernel_kind(e.key)] += e.count
    busy_us = sum(kinds.values())
    if busy_us == 0:
        emit(phase=phase, device_time="not measured", **extra)
        return
    emit(phase=phase, iterations=n,
         ms_per_iteration={k: v / n / 1e3 for k, v in kinds.items()},
         launches_per_iteration={k: v / n for k, v in launches.items()},
         busy_ms_per_iteration=busy_us / n / 1e3,
         wall_ms_per_iteration=wall_us / n / 1e3,
         idle_share=max(0.0, 1.0 - busy_us / wall_us), **extra)


def phase_profile(model, x, iters: int = 3) -> None:
    """Device time by kernel kind over ``iters`` forwards (torch.profiler)
    and the device's idle share of the wall time."""
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _emit_kinds("profile", prof, iters, wall_us, batch=x.shape[0])


_COUNTED = (dw.fused_depthwise, dw.depthwise_dx, dw.depthwise_dwgrad,
            fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)


def _reset_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def _counts():
    """Launches of (depthwise forward, dx, dw gradient) since the reset."""
    return (dw.fused_depthwise.launches, dw.depthwise_dx.launches,
            dw.depthwise_dwgrad.launches)


def _flash_counts():
    """Launches of (flash forward, dQ, dK/dV) since the reset."""
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def phase_train(frame: str) -> dict:
    """``runners.train`` in-process on the flagship at 12×600², batch 3:
    8 steps, validation of the model and its EMA, checkpoints; then the
    launch counts of one step and its device time by kernel kind."""
    out = OUT / "train"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(TRAIN_FLAGS + ["--output", str(out)])
    init = train_runner.build_model(cfg, "cpu").state_dict()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    result = train_runner.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, dxl, dwg = _counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(result["train"]["step_s"])
    n_eval = max(max(TRAIN_BATCH * 8, 16) // 2, 8)    # runners.train.setup
    eval_batches = math.ceil(n_eval / (2 * TRAIN_BATCH))
    want_fwd = 55 * steps + 55 * eval_batches * 2      # model + EMA eval
    if steps != 8 or (fwd, dxl, dwg) != (want_fwd, 55 * steps, 55 * steps):
        raise AssertionError(
            f"train path: {steps} steps, {fwd} forward, {dxl} dx and {dwg} "
            f"dw-gradient launches; expected 8, {want_fwd}, {55 * steps} and "
            f"{55 * steps}")
    if not (np.isfinite(result["train"]["loss"])
            and np.isfinite(result["eval"]["loss"])):
        raise AssertionError(f"non-finite loss: {result}")
    if result["train"]["nonfinite"]:
        raise AssertionError(f"{result['train']['nonfinite']} guarded steps")
    last = Path(result["output_dir"]) / "last.pth.tar"
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    moved = {}
    for part, sd in (("params", ckpt["state_dict"]),
                     ("ema", ckpt["state_dict_ema"])):
        moved[part] = sum(not torch.equal(v, init[k]) for k, v in sd.items()
                          if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked")))
        moved[part + "_bn"] = sum(
            not torch.equal(v, init[k]) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var")))
    if not all(moved.values()):
        raise AssertionError(f"state did not move in training: {moved}")
    score = runner.test_img(str(last), [frame], size=600, device="cuda")
    if not (len(score) == 1 and 0.0 <= score[0] <= 1.0):
        raise AssertionError(f"checkpoint scored {score}")
    step_s = result["train"]["step_s"][1:]        # the first one warms up
    ms_step = float(np.mean(step_s)) * 1e3
    emit(phase="train", steps=steps, forward_launches=fwd,
         dx_launches=dxl, dwgrad_launches=dwg, loss=result["train"]["loss"],
         eval_loss=result["eval"]["loss"], moved_leaves=moved,
         checkpoint=str(last.relative_to(ROOT)), score=score[0],
         ms_per_step=ms_step, step_ms=[v * 1e3 for v in step_s],
         samples_per_s=TRAIN_BATCH / (ms_step / 1e3),
         peak_mem_gib=peak / 2 ** 30, wall_s=wall)
    del result, ckpt, init
    gc.collect()
    torch.cuda.empty_cache()

    run = train_runner.setup(cfg)
    batches = list(itertools.islice(iter(run.train_loader), 4))
    run.train_step(run.state, *batches[0])
    torch.cuda.synchronize()
    _reset_counts()
    run.train_step(run.state, *batches[1])
    torch.cuda.synchronize()
    per_step = _counts()
    if per_step != (55, 55, 55):
        raise AssertionError(f"one train step launched {per_step} "
                             f"(forward, dx, dw-gradient); expected "
                             f"(55, 55, 55)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches[2:]:
            run.train_step(run.state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _emit_kinds("train_profile", prof, len(batches) - 2, wall_us,
                batch=TRAIN_BATCH)
    del run, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(forward_launches=fwd, dx_launches=dxl, dwgrad_launches=dwg)


def _flagship(device: str):
    return create_deepfake_model_v4(device=device, seed=1, bn_momentum=0.1)


def _timesformer(size: int):
    def build(device: str):
        return create_model(TSF_MODEL, num_classes=2, in_chans=12,
                            img_size=size, attn_impl="flash", device=device,
                            seed=1)
    return build


def _train_one_step(build, device: str, x: np.ndarray, y: np.ndarray,
                    threads: int = 0):
    """One guarded rmsproptf step of the seeded model ``build(device)``;
    returns the loss, the state dict before and after (CPU), and the live
    state and step for more steps."""
    if threads:
        torch.set_num_threads(threads)
    model = build(device)
    state = create_train_state(model, create_optimizer(
        train_runner.TrainConfig(opt="rmsproptf"), model, 1e-3),
        with_ema=True)
    step = make_train_step(losses.soft_target_cross_entropy,
                           nonfinite_guard=True)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    xd = torch.from_numpy(x).to(device).contiguous(
        memory_format=torch.channels_last)
    yd = torch.from_numpy(y).to(device)
    t0 = time.perf_counter()
    loss = float(step(state, xd, yd)["loss"])
    return dict(loss=loss, s=time.perf_counter() - t0, before=before,
                after={k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
                state=state, step=step, x=xd, y=yd)


def phase_card_vs_cpu(name: str = "flagship", build=_flagship,
                      size: int = 224, batch: int = 2) -> None:
    """One guarded rmsproptf step of a full-width, full-depth model from the
    same weights on the card and on the CPU (all cores, and one core for the
    CPU's own f32 rounding noise); then a NaN batch on the card."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((batch, 12, size, size)).astype(np.float32)
    y = np.array([[0.9, 0.1], [0.2, 0.8]], np.float32)[:batch]
    gpu = _train_one_step(build, "cuda", x, y)
    cpu = _train_one_step(build, "cpu", x, y, threads=os.cpu_count() or 1)
    cpu1 = _train_one_step(build, "cpu", x, y, threads=1)
    del cpu["state"], cpu1["state"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    if not np.isfinite(gpu["loss"]) or loss_rel > LOSS_TOL:
        raise AssertionError(f"card vs CPU loss {gpu['loss']} vs "
                             f"{cpu['loss']}: {loss_rel:.3e} > {LOSS_TOL}")
    # Each parameter's update (after - before) against UPDATE_TOL of its own
    # max, plus: 2 f32 ulps of the weight (the update is a difference of two
    # rounded f32 weights); a floor of 1e-6 of the largest update (leaves
    # whose gradient cancels to rounding noise, as a BN bias feeding the
    # next BN); and twice the CPU's own disagreement on that leaf between
    # all cores and one core (f32 noise amplified through 55 blocks of
    # backprop reaches ~1e-3 of the update on the first blocks' weights).
    upd = {k: (cpu["after"][k] - cpu["before"][k],
               gpu["after"][k] - gpu["before"][k],
               cpu1["after"][k] - cpu1["before"][k])
           for k in cpu["before"] if cpu["before"][k].is_floating_point()
           and not k.endswith(("running_mean", "running_var"))}
    floor = 1e-6 * max(u[0].abs().max().item() for u in upd.values())
    worst_upd = worst_self = usage = 0.0
    for k, (uc, ug, u1) in upd.items():
        err = (ug - uc).abs().max().item()
        noise = (u1 - uc).abs().max().item()
        scale = uc.abs().max().item()
        ulps = 2 * EPS32 * cpu["after"][k].abs().max().item()
        bound = UPDATE_TOL * scale + ulps + floor + 2 * noise
        if err > bound:
            raise AssertionError(f"{k}: card vs CPU update differs by "
                                 f"{err:.3e} > {bound:.3e}")
        usage = max(usage, err / bound)
        # the relative figures over updates well above f32 resolution
        if scale > 1e3 * floor and scale > 500 * ulps:
            worst_upd = max(worst_upd, err / scale)
            worst_self = max(worst_self, noise / scale)
    worst_bn = 0.0
    for k, v in cpu["after"].items():
        if k.endswith("running_var"):
            base = k[:-len("running_var")]
            spread = float(v.max().sqrt())
            for leaf, scale in (("running_mean", spread),
                                ("running_var", spread ** 2)):
                diff = (gpu["after"][base + leaf]
                        - cpu["after"][base + leaf]).abs().max().item()
                if diff > 1e-4 * scale:
                    raise AssertionError(f"{base + leaf}: card vs CPU "
                                         f"{diff:.3e} > 1e-4 · {scale:.3e}")
                worst_bn = max(worst_bn, diff / scale)
    emit(phase="card_vs_cpu", model=name, size=size, batch=batch,
         loss_gpu=gpu["loss"],
         loss_cpu=cpu["loss"], loss_cpu_1_thread=cpu1["loss"],
         loss_rel_diff=loss_rel, max_update_rel_diff=worst_upd,
         cpu_self_max_update_rel_diff=worst_self, update_floor=floor,
         max_err_over_bound=usage,
         max_bn_stat_rel_diff=worst_bn, leaves=len(upd), gpu_s=gpu["s"],
         cpu_s=cpu["s"], cpu_1_thread_s=cpu1["s"],
         tol=dict(loss=LOSS_TOL, update=UPDATE_TOL, bn_stats=1e-4))
    # the guard: a NaN batch through the card's step changes nothing
    state, step = gpu["state"], gpu["step"]
    before = [t.clone() for t in state.tensors()]
    m = step(state, torch.full_like(gpu["x"], float("nan")), gpu["y"])
    torch.cuda.synchronize()
    after = state.tensors()
    same = sum(torch.equal(a, b) for a, b in zip(after, before))
    if float(m["nonfinite"]) != 1.0 or same != len(before) or \
            int(state.step) != 1:
        raise AssertionError(f"NaN batch: nonfinite {float(m['nonfinite'])},"
                             f" {same}/{len(before)} tensors unchanged, "
                             f"step {int(state.step)}")
    emit(phase="guard", model=name, nonfinite=float(m["nonfinite"]),
         tensors_unchanged=same, tensors=len(before), step=int(state.step))


def _flash_inputs(bh, l, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, l, d), generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _close(name, got, want, tol) -> float:
    """Elementwise |got - want| ≤ atol + rtol·|want|; returns the max
    absolute error."""
    diff = (got.float() - want.float()).abs()
    if (got.shape != want.shape or not torch.isfinite(got).all()
            or bool((diff > tol[0] + tol[1] * want.float().abs()).any())):
        raise AssertionError(f"{name}: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, max |kernel - plain| "
                             f"{diff.max().item():.3e} over atol {tol[0]} + "
                             f"rtol {tol[1]}")
    return diff.max().item()


def check_flash(name, bh, l, d, seq_len, causal=False, q_off=0, kv_off=0,
                dtype=torch.float32, seed=0) -> dict:
    """The three flash kernels against their plain versions on the same
    inputs: O elementwise (BF16_TOL for bf16), lse elementwise, dQ, dK and
    dV within FLASH_GRAD_TOL of their max; two forward and two backward
    calls must agree bitwise; rows that the causal offsets hide must give
    o = 0 and lse = log(1e-30).  Returns the max absolute error of each
    kernel and the largest gradient error relative to its max
    (grad_rel)."""
    q, k, v, do = _flash_inputs(bh, l, d, dtype, seed)
    args = (d ** -0.5, seq_len, causal, q_off, kv_off)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o2, lse2 = fa.flash_fwd(q, k, v, *args)
    ro, rlse = fa.flash_fwd_reference(q, k, v, *args)
    delta = (do.float() * o.float()).sum(-1)
    dq = [fa.flash_bwd_dq(q, k, v, do, lse, delta, *args) for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
           for _ in range(2)]
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, *args)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    if o.dtype != dtype or lse.dtype != torch.float32:
        raise AssertionError(f"{name}: o {o.dtype}, lse {lse.dtype}")
    err = dict(fwd=max(_close(f"{name} o", o, ro, BF16_TOL if dtype ==
                              torch.bfloat16 else FLASH_TOL),
                       _close(f"{name} lse", lse, rlse, FLASH_TOL)))
    if causal and kv_off > q_off:          # rows that see no key
        hidden = min(kv_off - q_off, l)
        if not (torch.equal(o[:, :hidden].float(),
                            torch.zeros_like(o[:, :hidden].float()))
                and torch.allclose(lse[:, :hidden], torch.full_like(
                    lse[:, :hidden], math.log(np.float32(1e-30))),
                    rtol=1e-6, atol=0)):
            raise AssertionError(f"{name}: hidden rows give o != 0 or lse "
                                 f"!= log(1e-30)")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{name}: two forward calls differ")
    if not (torch.equal(dq[0], dq[1]) and torch.equal(dkv[0][0], dkv[1][0])
            and torch.equal(dkv[0][1], dkv[1][1])):
        raise AssertionError(f"{name}: two backward calls differ")
    err["grad_rel"] = 0.0
    for label, got, want in (("dq", dq[0], rdq), ("dk", dkv[0][0], rdk),
                             ("dv", dkv[0][1], rdv)):
        rel = _rel_err(got, want)
        if not torch.isfinite(got).all() or rel > FLASH_GRAD_TOL:
            raise AssertionError(f"{name}: {label} |kernel - plain| / "
                                 f"max|plain| {rel:.3e} > {FLASH_GRAD_TOL}")
        err["grad_rel"] = max(err["grad_rel"], rel)
    err["dq"] = (dq[0] - rdq).abs().max().item()
    err["dkv"] = max((dkv[0][0] - rdk).abs().max().item(),
                     (dkv[0][1] - rdv).abs().max().item())
    return err


def flash_costs(bh, l, d, itemsize=4):
    """(bytes, operations) each flash kernel must move and do at a
    non-causal (BH, L, D) call: every input read once and every output
    written once; the matrix products' multiply-adds as 2 operations each
    (S = QKᵀ, PV, dP = dO Vᵀ, dS K, Pᵀ dO, dSᵀ Q are 2·L²·D a row of BH;
    the L² exponentials are left out, under 2% of the count)."""
    x = bh * l * d * itemsize
    row = bh * l * 4                               # lse, delta (f32)
    mm = 2 * bh * l * l * d
    return dict(fwd=(4 * x + row, 2 * mm),         # q k v → o, lse
                dq=(4 * x + 2 * row + bh * l * d * 4, 3 * mm),
                dkv=(4 * x + 2 * row + 2 * bh * l * d * 4, 4 * mm))


def flash_bounds(nbytes, ops) -> dict:
    """The least time of an f32 flash kernel: the larger of its bytes over
    the memory rate and its operations over the faster f32-accurate rate,
    the f32 SIMT units (67 TFLOP/s) or the tensor cores taking each product
    as three TF32 products (3 × ops at 495 TFLOP/s)."""
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    simt_ms = ops / F32_FLOP_PER_S * 1e3
    tf32x3_ms = 3 * ops / TF32_FLOP_PER_S * 1e3
    ops_ms = min(simt_ms, tf32x3_ms)
    return dict(bytes_ms=bytes_ms, simt_bound_ms=simt_ms,
                tf32x3_bound_ms=tf32x3_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate="3xTF32 tensor cores" if tf32x3_ms <= simt_ms
                else "f32 SIMT")


def sdpa(q, k, v):
    """The library yardstick: SDPA pinned to its memory-efficient backend
    (PyTorch's f32 attention kernel, forward and backward) on (B·H, L, D)
    as (1, B·H, L, D): its fused kernels take 4-D inputs only, and a 3-D
    call falls back to the unfused math path."""
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]


def backward_device_ms(attend, q, k, v, do):
    """Device time of one backward of ``attend(q, k, v)`` alone, timed as
    the kernels are (:func:`device_ms`): the forward runs once on a side
    stream and is kept, and the graph captures ``torch.autograd.grad``
    over it on that stream (autograd runs a backward op on its forward's
    stream).  Returns (ms, the attention's autograd node, {backward
    kernel: device ms a call} from torch.profiler over 3 more calls)."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = attend(*ins)

    def grad():
        torch.autograd.grad(out, ins, do, retain_graph=True)
    ms = device_ms(grad, stream=side)
    with torch.cuda.stream(side), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            grad()
        torch.cuda.synchronize()
    kernels = {e.key[:100]: e.self_device_time_total / 3 / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    nodes, todo = [], [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            nodes.append(fn.name())
            todo += [nxt for nxt, _ in fn.next_functions]
    node = next((n for n in nodes if "Attention" in n), nodes[0])
    return ms, node, kernels or "not measured"


def phase_flash() -> dict:
    """The flash kernels against their plain versions at the TimeSformer's
    shapes (a train step's spatial attention, BH 384, and an eval forward's
    at batch 16, BH 768; L 576, D 64, f32) and at edge cases; then device
    times at both path shapes: kernel, plain, SDPA (library, pinned to its
    memory-efficient backend; its backward alone, as the port's autograd
    backward) and both bounds; returns the BH-384 row and the max
    errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = Counter()

    def fold(e):
        for key, v in e.items():
            errs[key] = max(errs[key], v)

    rows = {}
    for i, bh in enumerate(FLASH_BH):
        fold(check_flash(f"path BH {bh}", bh, FLASH_L, FLASH_D, FLASH_L,
                         seed=900 + i))
        q, k, v, do = _flash_inputs(bh, FLASH_L, FLASH_D, torch.float32,
                                    910 + i)
        scale, lq = FLASH_D ** -0.5, FLASH_L
        o, lse = fa.flash_fwd(q, k, v, scale, lq)
        delta = (do * o).sum(-1)
        bw = (q, k, v, do, lse, delta, scale, lq)
        row = dict(
            fwd_ms=device_ms(lambda: fa.flash_fwd(q, k, v, scale, lq)),
            fwd_plain_ms=device_ms(lambda: fa.flash_fwd_reference(
                q, k, v, scale, lq)),
            fwd_library_ms=device_ms(lambda: sdpa(q, k, v)),
            dq_ms=device_ms(lambda: fa.flash_bwd_dq(*bw)),
            dq_plain_ms=device_ms(lambda: fa.flash_bwd_dq_reference(*bw)),
            dkv_ms=device_ms(lambda: fa.flash_bwd_dkv(*bw)),
            dkv_plain_ms=device_ms(lambda: fa.flash_bwd_dkv_reference(*bw)))
        # the whole backward of one attention, the port's autograd node
        # (delta, dK/dV, dQ, casts) against SDPA's, each alone on the device
        row["bwd_ms"], _, row["bwd_kernels"] = backward_device_ms(
            lambda a, b, c: fa.FlashAttentionFunction.apply(a, b, c, scale,
                                                            False),
            q, k, v, do)
        (row["library_bwd_ms"], row["library_backend"],
         row["library_bwd_kernels"]) = backward_device_ms(sdpa, q, k, v, do)
        if "Efficient" not in row["library_backend"]:
            raise AssertionError(f"SDPA ran {row['library_backend']}, not "
                                 f"its memory-efficient backend")
        row["bwd_pair_ms"] = row["dq_ms"] + row["dkv_ms"]
        for kind, (nbytes, ops) in flash_costs(bh, FLASH_L, FLASH_D).items():
            for key, val in flash_bounds(nbytes, ops).items():
                row[f"{kind}_{key}"] = val
            row[f"{kind}_bound_share"] = row[f"{kind}_bound_ms"] \
                / row[f"{kind}_ms"]
            row[f"{kind}_tflop_per_s"] = ops / row[f"{kind}_ms"] / 1e9
        rows[bh] = row
        emit(phase="flash_row", bh=bh, l=FLASH_L, d=FLASH_D, dtype="float32",
             **row)
        del q, k, v, do, o, lse, delta, bw
    edges = [("L 197", 48, 197, 64, 197),
             ("L 200", 48, 200, 64, 200),
             ("D 32", 24, 200, 32, 200),
             ("D 48 L 197", 24, 197, 48, 197),
             ("D 128 L 130", 12, 130, 128, 130),
             ("D 128 L 576", 24, 576, 128, 576),
             ("key padding 150/200", 24, 200, 64, 150)]
    for j, (name, bh, l, d, seq_len) in enumerate(edges):
        fold(check_flash(name, bh, l, d, seq_len, seed=920 + j))
    causal = [("causal", 24, 200, 64, 200, 0, 0),
              ("causal kv_off 16: 16 rows see no key", 24, 200, 64, 200, 0,
               16),
              ("causal q_off 64 (a later ring shard)", 24, 192, 48, 192, 64,
               0),
              ("causal, padding, offsets 7/40", 24, 200, 64, 150, 7, 40),
              ("causal kv_off 300: every row hidden", 6, 130, 64, 130, 0,
               300)]
    for j, (name, bh, l, d, seq_len, q_off, kv_off) in enumerate(causal):
        fold(check_flash(name, bh, l, d, seq_len, True, q_off, kv_off,
                         seed=940 + j))
    bf16 = Counter()
    for j, (name, bh, l, d) in enumerate([("bf16 path", FLASH_BH[0], 576, 64),
                                          ("bf16 D 48 L 197", 24, 197, 48)]):
        for key, v in check_flash(name, bh, l, d, l, dtype=torch.bfloat16,
                                  seed=960 + j).items():
            bf16[key] = max(bf16[key], v)
    emit(phase="flash", cases=2 + len(edges) + len(causal) + 2,
         max_abs_err=dict(errs), bf16_max_abs_err=dict(bf16), bitwise=True,
         tol=dict(f32=FLASH_TOL, bf16_o=BF16_TOL, grad=FLASH_GRAD_TOL))
    return dict(row=rows[FLASH_BH[0]], eval_row=rows[FLASH_BH[1]],
                max_abs_err=dict(errs))


_FLASH_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv))_kernelI"
                           r"(f|13__nv_bfloat16)Li(\d+)E")


def _flash_kernel_key(mangled: str):
    m = _FLASH_KERNEL.search(mangled)
    return m and f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}>"


def _ptxas_report(lib: Path, key_fn) -> dict:
    """ptxas' registers, stack and spills of each kernel in the build log
    beside ``lib`` whose mangled name ``key_fn`` maps to a key."""
    out, key = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            key = key_fn(line)
            if key:
                out[key] = {}
        elif key and "bytes stack frame" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[key].update(stack_bytes=n[0], spill_store_bytes=n[1],
                            spill_load_bytes=n[2])
        elif key and "registers" in line:
            out[key]["ptxas_registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


_DW_KERNEL = re.compile(r"(dw_fwd|dw_dx)_kernelI(f|13__nv_bfloat16)Li(\d)E"
                        r"Li(\d)ELb(\d)E")


def _dw_kernel_key(mangled: str):
    m = _DW_KERNEL.search(mangled)
    return m and (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},k{m[3]},"
                  f"s{m[4]},{'vec' if m[5] == '1' else 'scalar'}>")


def phase_depthwise_kernels(libs: dict) -> dict:
    """For every instantiation of the depthwise forward and dx kernels:
    ptxas' registers, stack and spills (the build's ``-Xptxas -v``
    report), and what the card gives it (registers, local bytes, the
    largest dynamic shared memory its tiles take, resident blocks per SM
    at that size and 128 threads: cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = {}
    for name, short in (("depthwise_fwd", "dw_fwd"), ("depthwise_dx", "dw_dx")):
        out.update(_ptxas_report(libs[name], _dw_kernel_key))
        info = kernel(name, f"dfd_{name}_info", [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        for dtype, k, s, vec in itertools.product((0, 1), (3, 5), (1, 2),
                                                  (1, 0)):
            got = (ctypes.c_int * 4)()
            err = info(k, s, dtype, vec, ctypes.addressof(got))
            key = (f"{short}<{('f32', 'bf16')[dtype]},k{k},s{s},"
                   f"{'vec' if vec else 'scalar'}>")
            if err != 0:
                raise RuntimeError(f"{key} info: cudaError_t {err}")
            out.setdefault(key, {}).update(
                registers=got[0], local_bytes=got[1], smem_bytes=got[2],
                blocks_per_sm=got[3])
    emit(phase="depthwise_kernels", kernels=out)
    return out


def phase_flash_kernels(libs: dict) -> dict:
    """For every instantiation of the three flash kernels (the forward and
    the two backward kernels): ptxas' registers, stack and spills (the
    build's ``-Xptxas -v`` report), what the card gives it (registers, local
    bytes, dynamic shared memory, resident blocks per SM:
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    and, where the toolkit has ``cuobjdump``, the HMMA (tensor-core)
    instructions in its SASS.  Fails unless dK/dV at f32, D = 64 keeps two
    blocks on an SM, and (with cuobjdump) every instantiation runs on the
    tensor cores."""
    out = {}
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        out.update(_ptxas_report(libs[name], _flash_kernel_key))
        info = kernel(name, f"dfd_{name}_info",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        for dtype, tname in ((0, "f32"), (1, "bf16")):
            for d in (32, 64, 128):
                got = (ctypes.c_int * 4)()
                err = info(d, dtype, ctypes.addressof(got))
                if err != 0:
                    raise RuntimeError(f"{name} info D {d} {tname}: "
                                       f"cudaError_t {err}")
                out.setdefault(f"{name}<{tname},{d}>", {}).update(
                    registers=got[0], local_bytes=got[1], smem_bytes=got[2],
                    blocks_per_sm=got[3])
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if Path(cuobjdump).is_file():
            sass = subprocess.run([cuobjdump, "-sass", str(libs[name])],
                                  capture_output=True, text=True, timeout=300,
                                  check=True).stdout
            key = None
            for line in sass.splitlines():
                if "Function :" in line:
                    key = _flash_kernel_key(line)
                    if key:
                        out[key]["hmma"] = 0
                elif key and "HMMA" in line:
                    out[key]["hmma"] += 1
    emit(phase="flash_kernels", kernels=out)
    if out["flash_bwd_dkv<f32,64>"]["blocks_per_sm"] < 2:
        raise AssertionError(f"dK/dV at D 64 keeps "
                             f"{out['flash_bwd_dkv<f32,64>']['blocks_per_sm']}"
                             f" blocks on an SM, expected 2")
    no_tc = [k for k, v in out.items() if v.get("hmma") == 0]
    if no_tc:
        raise AssertionError(f"no HMMA in the SASS of {no_tc}")
    return out


def phase_flash_autograd() -> float:
    """``flash_attention`` on the card, forward and backward through the
    kernels, against ``torch.autograd`` through the plain forward, in the
    JAX layout (B, L, H, D): a path shape and a ragged one.  Returns the
    largest relative error of O and the three gradients."""
    worst = 0.0
    for j, (b, l, h, d, causal) in enumerate([(TSF_BATCH * 4, FLASH_L, 12,
                                               FLASH_D, False),
                                              (2, 197, 3, 64, True)]):
        g = torch.Generator(device="cuda").manual_seed(980 + j)
        q, k, v, gy = (torch.randn((b, l, h, d), generator=g, device="cuda")
                       for _ in range(4))
        outs, grads = [], []
        for attend in ("kernel", "plain"):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            if attend == "kernel":
                y = fa.flash_attention(*ins, causal=causal)
            else:
                bh = [t.permute(0, 2, 1, 3).reshape(b * h, l, d) for t in ins]
                y = fa.flash_fwd_reference(*bh, d ** -0.5, l, causal)[0]
                y = y.view(b, h, l, d).permute(0, 2, 1, 3)
            grads.append(torch.autograd.grad(y, ins, gy))
            outs.append(y.detach())
        torch.cuda.synchronize()
        for label, got, want in zip(("o", "dq", "dk", "dv"),
                                    (outs[0], *grads[0]),
                                    (outs[1], *grads[1])):
            rel = _rel_err(got, want)
            if not torch.isfinite(got).all() or rel > FLASH_GRAD_TOL:
                raise AssertionError(f"flash_attention ({b}, {l}, {h}, {d}) "
                                     f"causal={causal}: {label} |card - "
                                     f"autograd| / max {rel:.3e} > "
                                     f"{FLASH_GRAD_TOL}")
            worst = max(worst, rel)
    emit(phase="flash_autograd", max_rel_err=worst, tol=FLASH_GRAD_TOL)
    return worst


def phase_tsf_train() -> dict:
    """``runners.train`` in-process on ``timesformer_base_patch25_600`` at
    12×600², batch 8, ``--attn-impl flash``: 8 steps, validation of the
    model and its EMA, a checkpoint; 12 forward, 12 dQ and 12 dK/dV kernel
    launches a step and 12 forward launches an eval forward; the EMA
    reloaded from the checkpoint scores the eval set as the run did; then
    one step's device time by kernel kind and the eval forward's clips/s
    at batch 16."""
    out = OUT / "tsf_train"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(TSF_FLAGS + ["--output", str(out)])
    init = train_runner.build_model(cfg, "cpu").state_dict()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    result = train_runner.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, dq, dkv = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(result["train"]["step_s"])
    n_eval = max(max(TSF_BATCH * 8, 16) // 2, 8)      # runners.train.setup
    eval_forwards = 2 * math.ceil(n_eval / (2 * TSF_BATCH))  # model + EMA
    want = (TSF_BLOCKS * (steps + eval_forwards), TSF_BLOCKS * steps,
            TSF_BLOCKS * steps)
    if steps != 8 or (fwd, dq, dkv) != want or _counts() != (0, 0, 0):
        raise AssertionError(
            f"TimeSformer train path: {steps} steps, (forward, dQ, dK/dV) "
            f"launches {(fwd, dq, dkv)}, depthwise {_counts()}; expected 8, "
            f"{want}, (0, 0)")
    if not (np.isfinite(result["train"]["loss"])
            and np.isfinite(result["eval"]["loss"])):
        raise AssertionError(f"non-finite loss: {result}")
    if result["train"]["nonfinite"]:
        raise AssertionError(f"{result['train']['nonfinite']} guarded steps")
    last = Path(result["output_dir"]) / "last.pth.tar"
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    moved = {part: sum(not torch.equal(v, init[k]) for k, v in sd.items())
             for part, sd in (("params", ckpt["state_dict"]),
                              ("ema", ckpt["state_dict_ema"]))}
    if not all(moved.values()):
        raise AssertionError(f"state did not move in training: {moved}")
    step_s = result["train"]["step_s"][1:]        # the first one warms up
    ms_step = float(np.mean(step_s)) * 1e3
    del init
    gc.collect()
    torch.cuda.empty_cache()

    # the checkpoint's EMA, loaded into a fresh run, scores the eval set as
    # the run's last validation (the EMA's) did
    run = train_runner.setup(cfg)
    run.state.model.load_state_dict(ckpt["state_dict_ema"])
    again = validate(run.eval_step, run.state, run.eval_loader, cfg)
    rel = abs(again["loss"] - result["eval"]["loss"]) / abs(
        result["eval"]["loss"])
    if rel > 1e-5:
        raise AssertionError(f"reloaded EMA eval loss {again['loss']} vs "
                             f"{result['eval']['loss']} in the run")
    emit(phase="tsf_train", steps=steps, forward_launches=fwd,
         dq_launches=dq, dkv_launches=dkv, loss=result["train"]["loss"],
         eval_loss=result["eval"]["loss"], reloaded_eval_loss=again["loss"],
         moved_leaves=moved, checkpoint=str(last.relative_to(ROOT)),
         ms_per_step=ms_step, step_ms=[v * 1e3 for v in step_s],
         samples_per_s=TSF_BATCH / (ms_step / 1e3),
         peak_mem_gib=peak / 2 ** 30, wall_s=wall)
    del result, ckpt

    batches = list(itertools.islice(iter(run.train_loader), 4))
    run.train_step(run.state, *batches[0])
    torch.cuda.synchronize()
    _reset_counts()
    run.train_step(run.state, *batches[1])
    torch.cuda.synchronize()
    if _flash_counts() != (TSF_BLOCKS,) * 3:
        raise AssertionError(f"one train step launched {_flash_counts()} "
                             f"(forward, dQ, dK/dV); expected 12 each")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches[2:]:
            run.train_step(run.state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _emit_kinds("tsf_train_profile", prof, len(batches) - 2, wall_us,
                batch=TSF_BATCH)
    del batches

    model = run.state.model.eval()
    x = torch.randn(2 * TSF_BATCH, 12, 600, 600, device="cuda").contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        _reset_counts()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if _flash_counts() != (TSF_BLOCKS * iters, 0, 0):
        raise AssertionError(f"{iters} eval forwards launched "
                             f"{_flash_counts()}")
    emit(phase="tsf_eval_throughput", batch=2 * TSF_BATCH,
         clips_per_s=2 * TSF_BATCH * iters / dt,
         ms_per_forward=dt / iters * 1e3)
    del run, model, x
    gc.collect()
    torch.cuda.empty_cache()
    return dict(forward_launches=fwd, dq_launches=dq, dkv_launches=dkv)


def flash_entries(fl: dict, autograd_err: float, tsf: dict) -> list:
    """The ``kernels`` line's entries of the three flash kernels: launches
    from the TimeSformer's training path, times per call at its train
    step's shape."""
    row, ev = fl["row"], fl["eval_row"]
    out = []
    for kind, line, launches in (("fwd", 106, tsf["forward_launches"]),
                                 ("dq", 272, tsf["dq_launches"]),
                                 ("dkv", 216, tsf["dkv_launches"])):
        name = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
                "dkv": "flash_bwd_dkv"}[kind]
        out.append(dict(
            name=name, route="cuda",
            source=f"deepfake_detection_tpu_torch/csrc/{name}.cu",
            replaces=f"deepfake_detection_tpu/ops/flash_attention.py:{line}",
            launches=launches, launches_by_path={"tsf_train": launches},
            max_abs_err=fl["max_abs_err"][kind], ms=row[f"{kind}_ms"],
            plain_ms=row[f"{kind}_plain_ms"],
            bound_ms=row[f"{kind}_bound_ms"],
            bound_by=row[f"{kind}_bound_by"],
            bound_rate=row[f"{kind}_bound_rate"],
            simt_bound_ms=row[f"{kind}_simt_bound_ms"],
            tf32x3_bound_ms=row[f"{kind}_tf32x3_bound_ms"],
            bound_share=row[f"{kind}_bound_share"],
            library_ms=row["fwd_library_ms"] if kind == "fwd" else None,
            eval_ms=ev[f"{kind}_ms"], eval_bound_ms=ev[f"{kind}_bound_ms"],
            timing="device time per call (CUDA graph replay between CUDA "
                   f"events) at (B·H, L, D) = ({FLASH_BH[0]}, {FLASH_L}, "
                   f"{FLASH_D}) f32, a train step's spatial attention; "
                   f"eval_*: ({FLASH_BH[1]}, ...), an eval forward at batch "
                   f"{2 * TSF_BATCH}; library: SDPA, memory-efficient "
                   f"backend"))
    for entry in out[1:]:
        entry.update(library_bwd_ms=row["library_bwd_ms"],
                     library_backend=row["library_backend"],
                     bwd_pair_ms=row["bwd_pair_ms"], bwd_ms=row["bwd_ms"],
                     eval_library_bwd_ms=ev["library_bwd_ms"])
    out[0]["autograd_max_rel_err"] = autograd_err
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = build()
    emit(phase="build", s=time.perf_counter() - t0,
         ptxas={name: [ln.strip() for ln in path.with_suffix(".log")
                       .read_text().splitlines() if "registers" in ln]
                for name, path in libs.items()},
         libraries=[path.name for path in libs.values()])
    phase_flash_kernels(libs)
    phase_depthwise_kernels(libs)

    model = create_deepfake_model_v4(device="cpu")
    shapes = flagship_dw_shapes(model, 600)
    del model
    if dict(shapes) != FLAGSHIP_DW:
        raise AssertionError(f"flagship depthwise shapes {dict(shapes)}")
    k = phase_kernels(shapes)
    g = phase_dwgrad(shapes)
    d = phase_dx(shapes)
    b = phase_backward(shapes)
    fl = phase_flash()
    fl_autograd = phase_flash_autograd()

    # each path runs with the launch counts set to 0 just before it
    _reset_counts()
    infer_launches, frame = phase_main_path()
    if _counts()[1:] != (0, 0) or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the inference path launched the dx, "
                             f"dw-gradient and flash kernels {_counts()[1:]}"
                             f", {_flash_counts()} times")
    t = phase_train(frame)
    tsf = phase_tsf_train()
    phase_card_vs_cpu()
    phase_card_vs_cpu(TSF_MODEL, _timesformer(300), size=300, batch=2)

    emit(kernels=[
        dict(name="depthwise_fwd", route="cuda",
             source="deepfake_detection_tpu_torch/csrc/depthwise_fwd.cu",
             replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:138",
             launches=infer_launches + t["forward_launches"],
             launches_by_path={"inference": infer_launches,
                               "train": t["forward_launches"]},
             max_abs_err=max(k["max_abs_err"], b["y_max_abs_err"]),
             ms=k["ms"], kernel_ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by="bytes" if k["bytes_ms"] >= k["ops_ms"]
             else "operations",
             library_ms=k["library_ms"],
             dx_source="deepfake_detection_tpu_torch/csrc/depthwise_dx.cu",
             dx_ms=d["ms"], dx_library_ms=d["library_ms"],
             dx_bound_ms=d["bound_ms"],
             timing="device time (CUDA graph replay between CUDA events) "
                    "summed over the flagship's 55 depthwise stages at a "
                    f"600² input, f32: the forward at batch {MAIN_BATCH}, "
                    f"dx (its own kernel, no dilated copy) at batch "
                    f"{TRAIN_BATCH}"),
        dict(name="depthwise_dx", route="cuda",
             source="deepfake_detection_tpu_torch/csrc/depthwise_dx.cu",
             replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:138 "
                      "(reused for dx by _op_bwd, :387-403)",
             launches=t["dx_launches"],
             launches_by_path={"train": t["dx_launches"]},
             max_abs_err=d["max_abs_err"], max_rel_err=d["max_rel_err"],
             ms=d["ms"], kernel_ms=d["ms"], plain_ms=d["plain_ms"],
             bound_ms=d["bound_ms"],
             bound_by="bytes" if d["bytes_ms"] >= d["ops_ms"]
             else "operations",
             library_ms=d["library_ms"],
             timing="device time (CUDA graph replay between CUDA events) "
                    "summed over the flagship's 55 depthwise stages at a "
                    f"600² input, batch {TRAIN_BATCH}, f32; max_abs_err "
                    "over the f32 cases, max_rel_err over all, relative to "
                    "dx's max |plain|; library: cuDNN's conv2d_input"),
        dict(name="depthwise_dwgrad", route="cuda",
             source="deepfake_detection_tpu_torch/csrc/depthwise_dwgrad.cu",
             replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:214",
             launches=t["dwgrad_launches"],
             launches_by_path={"train": t["dwgrad_launches"]},
             max_abs_err=g["max_abs_err"], ms=g["ms"], kernel_ms=g["ms"],
             plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
             bound_by="bytes" if g["bytes_ms"] >= g["ops_ms"]
             else "operations",
             library_ms=g["library_ms"],
             timing="device time (CUDA graph replay between CUDA events) "
                    "summed over the flagship's 55 depthwise stages at a "
                    f"600² input, batch {TRAIN_BATCH}, f32"),
        *flash_entries(fl, fl_autograd, tsf)])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
