"""Device time of the port's flash and depthwise kernels, for comparing
two checkouts.

Run on one NVIDIA GPU, once per package root, in turns (A, B, B, A) inside
one machine so that both versions meet the same card::

    python3 flash_bench.py /path/to/checkout_a
    python3 flash_bench.py /path/to/checkout_b

(``--depthwise-only`` after the root times the depthwise kernels alone.)

Each run imports ``deepfake_detection_tpu_torch`` from the given root
(builds its kernels there at first use), and prints one JSON line: the
device ms per call of ``flash_fwd``, ``flash_bwd_dq`` and
``flash_bwd_dkv`` at a TimeSformer train step's spatial attention,
(B·H, L, D) = (384, 576, 64) f32, and an eval forward's (768, ...) (a CUDA
graph of 20 calls replayed 3 times between CUDA events, as
``chip_smoke.py`` times them); at B·H 384 the largest error of O and lse
against the plain forward (``fwd_err``, absolute) and of dQ, dK and dV
relative to each gradient's max against the plain versions (``rel_err``);
and ``depthwise_dwgrad`` timed the same way at each of the flagship's 14
depthwise stage shapes at batch 3, f32, summed with the stages' counts
(``dwgrad_ms``; 55 stages), with its largest error relative to dw's max
(``dwgrad_rel_err``); the depthwise forward (``fused_depthwise``, SiLU
epilogue with scale and bias) at batch 1 and dx at batch 3, timed the
same way at each of the 14 shapes (``dw_fwd_rows``, ``dx_rows``) and
summed with the counts (``dw_fwd_ms``, ``dx_ms``), with their largest
errors against the plain forward and autograd through it (``dw_fwd_err``
absolute, ``dx_rel_err`` relative to dx's max).  dx is what the checkout
runs for it: ``depthwise_dx`` where the package has it, else the forward
kernel over dz dilated by ``stride - 1`` (the dilation included).  Last,
the flagship's inference at 12×600², batch 8, f32 (``clips_per_s_b8``:
host clock around 10 forwards ending in a synchronize, after 2 warm-up
forwards, as ``chip_smoke.py``'s throughput phase).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

# the flagship's depthwise stages at 600²: (H in, C, k, stride) → count
# (chip_smoke.py, which imports this table, checks it against the model)
FLAGSHIP_DW = {(300, 256, 3, 1): 1, (300, 32, 3, 1): 3, (300, 192, 3, 2): 1,
               (150, 288, 3, 1): 6, (150, 288, 5, 2): 1, (75, 480, 5, 1): 6,
               (75, 480, 3, 2): 1, (38, 960, 3, 1): 9, (38, 960, 5, 1): 1,
               (38, 1344, 5, 1): 9, (38, 1344, 5, 2): 1,
               (19, 2304, 5, 1): 12, (19, 2304, 3, 1): 1,
               (19, 3840, 3, 1): 3}
TRAIN_BATCH = 3                   # scripts/train.sh: -b 3


def device_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 3,
              stream=None) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls captured in one
    CUDA graph after ``warmup`` calls on a side stream (``stream``, which
    the capture then uses too, where given), the graph replayed ``reps``
    times between CUDA events, mean per call.  The replay issues every
    kernel from the device, so the host's cost of issuing them does not
    count; gaps between the graph's kernels do.  The L2 is not flushed
    between calls."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def main(root: str, flash: bool = True) -> dict:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import deepfake_detection_tpu_torch
    from deepfake_detection_tpu_torch.ops import depthwise as dw
    from deepfake_detection_tpu_torch.ops import flash_attention as fa
    if not deepfake_detection_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {deepfake_detection_tpu_torch.__file__}"
                           f", not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    l, d = 576, 64
    for bh in (384, 768) if flash else ():
        gen = torch.Generator(device="cuda").manual_seed(910)
        q, k, v, do = (torch.randn((bh, l, d), generator=gen, device="cuda")
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_fwd(q, k, v, scale, l)
        bw = (q, k, v, do, lse, (do * o).sum(-1), scale, l)
        out[f"dq_{bh}"] = device_ms(lambda: fa.flash_bwd_dq(*bw))
        out[f"dkv_{bh}"] = device_ms(lambda: fa.flash_bwd_dkv(*bw))
        out[f"fwd_{bh}"] = device_ms(lambda: fa.flash_fwd(q, k, v, scale, l))
        if bh == 384:
            ro, rlse = fa.flash_fwd_reference(q, k, v, scale, l)
            out["fwd_err"] = [(o - ro).abs().max().item(),
                              (lse - rlse).abs().max().item()]
            got = (fa.flash_bwd_dq(*bw), *fa.flash_bwd_dkv(*bw))
            want = (fa.flash_bwd_dq_reference(*bw),
                    *fa.flash_bwd_dkv_reference(*bw))
            out["rel_err"] = [((a - b).abs().max() / b.abs().max()).item()
                              for a, b in zip(got, want)]
        del q, k, v, do, o, lse, bw
    out["dwgrad_ms"] = out["dwgrad_rel_err"] = 0.0
    for (h, c, k, s), count in sorted(FLAGSHIP_DW.items()):
        gen = torch.Generator(device="cuda").manual_seed(h * c + k)
        p = (s - 1 + k - 1) // 2               # the flagship's '' padding
        ho = (h + 2 * p - k) // s + 1
        x = torch.randn((TRAIN_BATCH, h, h, c), generator=gen, device="cuda")
        dz = torch.randn((TRAIN_BATCH, ho, ho, c), generator=gen,
                         device="cuda")
        pads = (p, p, p, p)
        ref = dw.depthwise_dwgrad_reference(x, dz, k, s, pads)
        got = dw.depthwise_dwgrad(x, dz, k, s, pads)
        out["dwgrad_rel_err"] = max(out["dwgrad_rel_err"], (
            (got - ref).abs().max() / ref.abs().max()).item())
        out["dwgrad_ms"] += count * device_ms(
            lambda: dw.depthwise_dwgrad(x, dz, k, s, pads))
    _depthwise_fwd_dx(dw, out)
    _inference(out)
    return out


def _inference(out: dict, batch: int = 8, iters: int = 10) -> None:
    """Clips/s of the seeded flagship's forward at 12×600², batch 8."""
    from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
    torch.backends.cudnn.allow_tf32 = False
    model = create_deepfake_model_v4(device="cuda", seed=0)
    x = torch.randn(batch, 12, 600, 600, device="cuda").contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        out["clips_per_s_b8"] = batch * iters / (time.perf_counter() - t0)


def _dx_fn(dw):
    """``dx(dz, w, x_shape, s, pads)`` as the checkout computes it on the
    card."""
    if hasattr(dw, "depthwise_dx"):
        return lambda dz, w, shape, s, pads: dw.depthwise_dx(
            dz, w, shape, s, pads, torch.float32)

    def dilated(dz, w, shape, s, pads):
        k = w.shape[0]
        wf = torch.flip(w, dims=(0, 1)).contiguous()
        dx_pads = dw.dx_padding(shape[1], shape[2], k, s, pads, dz.shape[1],
                                dz.shape[2])
        return dw.cuda_conv(dw.dilate(dz, s), wf, dx_pads)
    return dilated


def _depthwise_fwd_dx(dw, out: dict) -> None:
    """The depthwise forward at batch 1 and dx at batch 3 at the 14 stage
    shapes: per-stage device ms, count-weighted sums, largest errors."""
    dx_fn = _dx_fn(dw)
    out.update(dw_fwd_ms=0.0, dx_ms=0.0, dw_fwd_err=0.0, dx_rel_err=0.0,
               dw_fwd_rows={}, dx_rows={})
    for (h, c, k, s), count in sorted(FLAGSHIP_DW.items()):
        gen = torch.Generator(device="cuda").manual_seed(h * c + k + 1)
        p = (s - 1 + k - 1) // 2
        ho = (h + 2 * p - k) // s + 1
        pads = (p, p, p, p)
        w = torch.randn((k, k, c), generator=gen, device="cuda") * 0.2
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.rand(c, generator=gen, device="cuda") - 0.5
        x = torch.randn((1, h, h, c), generator=gen, device="cuda")
        y = dw.fused_depthwise(x, w, scale, bias, s, "", "silu")
        ref = dw.fused_depthwise_reference(x, w, scale, bias, s, "", "silu")
        out["dw_fwd_err"] = max(out["dw_fwd_err"],
                                (y - ref).abs().max().item())
        ms = device_ms(lambda: dw.fused_depthwise(x, w, scale, bias, s, "",
                                                  "silu"))
        key = f"{h}x{h}x{c} k{k} s{s}"
        out["dw_fwd_rows"][key] = ms
        out["dw_fwd_ms"] += count * ms
        del x, y, ref
        x = torch.randn((TRAIN_BATCH, h, h, c), generator=gen, device="cuda",
                        requires_grad=True)
        dz = torch.randn((TRAIN_BATCH, ho, ho, c), generator=gen,
                         device="cuda")
        (want,) = torch.autograd.grad(dw.fused_depthwise_reference(
            x, w, None, None, s, "", "none"), x, dz)
        shape = tuple(x.shape)
        got = dx_fn(dz, w, shape, s, pads)
        out["dx_rel_err"] = max(out["dx_rel_err"], (
            (got - want).abs().max() / want.abs().max()).item())
        ms = device_ms(lambda: dx_fn(dz, w, shape, s, pads))
        out["dx_rows"][key] = ms
        out["dx_ms"] += count * ms
        del x, dz, want, got


if __name__ == "__main__":
    args = sys.argv[1:]
    if (len(args) not in (1, 2) or args[1:] not in ([], ["--depthwise-only"])
            or not torch.cuda.is_available()):
        sys.exit("usage: python3 flash_bench.py PACKAGE_ROOT "
                 "[--depthwise-only] (needs CUDA)")
    print(json.dumps(main(args[0], flash=len(args) == 1)), flush=True)
