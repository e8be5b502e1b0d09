"""Device time of the port's flash and dw-gradient kernels, for comparing
two checkouts.

Run on one NVIDIA GPU, once per package root, in turns (A, B, B, A) inside
one machine so that both versions meet the same card::

    python3 flash_bench.py /path/to/checkout_a
    python3 flash_bench.py /path/to/checkout_b

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
(``dwgrad_rel_err``).
"""

from __future__ import annotations

import json
import sys
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


def main(root: str) -> dict:
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
    for bh in (384, 768):
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
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python3 flash_bench.py PACKAGE_ROOT (needs CUDA)")
    print(json.dumps(main(sys.argv[1])), flush=True)
