"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failure raises and exits non-zero
before the result line:

1. device: the card's ``nvidia-smi`` name and power limit, torch and CUDA;
2. build: ``nvcc`` compiles every kernel source of the port (timed);
3. kernels vs plain: the depthwise kernel at every depthwise shape of the
   flagship ``efficientnet_deepfake_v4`` at a 600² input (batch 1, the main
   path's, and batch 2; f32, TF32 off), bf16 on a few of them, and edge cases (C = 13, odd H/W, ``'same'``
   and int padding, act none/relu, identity affine, an unaligned base
   pointer), each against its plain PyTorch version on the same inputs;
   the device time of the kernel, the plain version and the library call
   (a CUDA graph of 20 calls replayed between CUDA events), beside the
   bound (bytes over the memory rate or operations over the f32 rate);
4. main path: the flagship at full width and depth (12×600², 55 blocks)
   with seeded weights and BN calibrated on the CPU by one train-mode
   pass over the inputs at 600², scoring seeded frames
   of mixed aspect ratios through ``runners.test.test_img`` on the card,
   single and ``--clip``; the kernel counts must show 55 launches per
   forward, scores must be finite, not all 0.5, and match the same weights
   run on the CPU (plain path); then clips/s at batch 1 and 8, and the
   device time by kernel kind at batch 8 (torch.profiler);
5. the ``kernels`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA, or in a directory that holds only this file, it exits
non-zero and prints no result.  Its files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
from deepfake_detection_tpu_torch.ops import depthwise as dw
from deepfake_detection_tpu_torch.ops.conv import explicit_padding
from deepfake_detection_tpu_torch.runners import test as runner

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# H100 SXM data-sheet peaks
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# the flagship's depthwise stages at 600²: (H in, C, k, stride) → count
FLAGSHIP_DW = {(300, 256, 3, 1): 1, (300, 32, 3, 1): 3, (300, 192, 3, 2): 1,
               (150, 288, 3, 1): 6, (150, 288, 5, 2): 1, (75, 480, 5, 1): 6,
               (75, 480, 3, 2): 1, (38, 960, 3, 1): 9, (38, 960, 5, 1): 1,
               (38, 1344, 5, 1): 9, (38, 1344, 5, 2): 1,
               (19, 2304, 5, 1): 12, (19, 2304, 3, 1): 1,
               (19, 3840, 3, 1): 3}

MAIN_BATCH = 1                    # test_img: one image or clip a forward
KERNEL_BATCHES = (MAIN_BATCH, 2)  # batches of the kernel-vs-plain rows

F32_TOL = (1e-5, 1e-5)            # |kernel - plain| ≤ atol + rtol·|plain|
BF16_TOL = (1e-6, 2.0 ** -7)      # one bf16 rounding apart, 2^-8 relative
SCORE_TOL = 1e-3                  # P(fake), card vs CPU, f32 over 55 blocks


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls captured in one
    CUDA graph after ``warmup`` calls on a side stream, the graph replayed
    ``reps`` times between CUDA events, mean per call.  The replay issues
    every kernel from the device, so the host's cost of issuing them does
    not count; gaps between the graph's kernels do.  The L2 is not flushed
    between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


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
    y = dw.fused_depthwise(x, w, scale, bias, stride, padding, act)
    ref = dw.fused_depthwise_reference(x, w, scale, bias, stride, padding,
                                       act)
    torch.cuda.synchronize()
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
    # no gradient through a CUDA stage yet: backward must raise
    xg = torch.randn(1, 8, 8, 16, device="cuda", requires_grad=True)
    try:
        dw.fused_depthwise(xg, torch.randn(3, 3, 16, device="cuda")).sum() \
            .backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("backward through the CUDA stage did not raise")
    for batch, tot in totals.items():
        emit(phase="kernels", batch=batch, rows=len(shapes),
             stages=sum(shapes.values()), max_abs_err=max_err, **tot)
    return dict(max_abs_err=max_err, **totals[MAIN_BATCH])


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


def phase_main_path(device: str = "cuda", size: int = 600) -> int:
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
    return launches


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "dw_fwd_kernel" in n:
        return "depthwise_fwd"
    if any(t in n for t in ("conv", "cudnn", "gemm", "xmma", "implicit",
                            "sm90", "cutlass")):
        return "conv_gemm"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


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
    kinds = Counter()
    launches = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kinds[_kernel_kind(e.key)] += e.self_device_time_total
            launches[_kernel_kind(e.key)] += e.count
    busy_us = sum(kinds.values())
    if busy_us == 0:
        emit(phase="profile", batch=x.shape[0], device_time="not measured")
        return
    emit(phase="profile", batch=x.shape[0], forwards=iters,
         ms_per_forward={k: v / iters / 1e3 for k, v in kinds.items()},
         launches_per_forward={k: v / iters for k, v in launches.items()},
         busy_ms_per_forward=busy_us / iters / 1e3,
         wall_ms_per_forward=wall_us / iters / 1e3,
         idle_share=max(0.0, 1.0 - busy_us / wall_us))


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
    lib = dw.build()
    regs = [ln.strip() for ln in lib.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln]
    emit(phase="build", s=time.perf_counter() - t0, library=lib.name,
         ptxas=regs)

    model = create_deepfake_model_v4(device="cpu")
    shapes = flagship_dw_shapes(model, 600)
    del model
    if dict(shapes) != FLAGSHIP_DW:
        raise AssertionError(f"flagship depthwise shapes {dict(shapes)}")
    k = phase_kernels(shapes)
    launches = phase_main_path()

    emit(kernels=[dict(
        name="depthwise_fwd", route="cuda",
        source="deepfake_detection_tpu_torch/csrc/depthwise_fwd.cu",
        replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:138",
        launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
        kernel_ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by="bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
        library_ms=k["library_ms"],
        timing="device time (CUDA graph replay between CUDA events) "
               "summed over the flagship's "
               f"55 depthwise stages at a 600² input, batch {MAIN_BATCH}, "
               "f32")])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
