"""Device time of the port's flash kernels, for comparing two checkouts.

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
``chip_smoke.py`` times them), and at B·H 384 the largest error of dQ, dK
and dV relative to each gradient's max against the plain versions.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch


def device_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 3) -> float:
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


def main(root: str) -> dict:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import deepfake_detection_tpu_torch
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
            got = (fa.flash_bwd_dq(*bw), *fa.flash_bwd_dkv(*bw))
            want = (fa.flash_bwd_dq_reference(*bw),
                    *fa.flash_bwd_dkv_reference(*bw))
            out["rel_err"] = [((a - b).abs().max() / b.abs().max()).item()
                              for a, b in zip(got, want)]
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage: python3 flash_bench.py PACKAGE_ROOT (needs CUDA)")
    print(json.dumps(main(sys.argv[1])), flush=True)
