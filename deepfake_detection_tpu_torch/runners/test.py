"""Single-image inference runner.

Counterpart of ``deepfake_detection_tpu/runners/test.py``: build the
flagship ``efficientnet_deepfake_v4``, load a checkpoint, preprocess each
image (aspect-preserving resize + center pad to the canvas, normalize,
replicate ×4 → 12 channels, or ``--clip``: 4 distinct frames concatenated)
and print the softmax fake score ``scores[:, 0]``.

Usage::

    python -m deepfake_detection_tpu_torch.runners.test img1.npy img2.png \\
        [--model-path PATH] [--image-size 600] [--clip] \\
        [--dtype f32|bf16|int8] [--device cuda]

``.npy`` files hold uint8 HWC RGB frames and are read with numpy; JPEG
files decode with the port's own decoder (``data/native.py``); other
formats need Pillow.  ``--model-path`` is a torch file with timm's keys.
``--dtype bf16|int8`` quantizes the loaded f32 weights
(``serving/quant.py``) and realizes them inside every forward: the serving
engine's PTQ, so the CLI is its oracle at each dtype.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import read_rgb
from ..models import create_deepfake_model_v4, load_checkpoint
from ..params import (image_max_height, img_num, make_score_fn,
                      normalize_concat, normalize_replicate, prepare_canvas)
from ..serving.quant import canonical_mode, quant_summary, quantize_module

__all__ = ["test_img", "preprocess", "preprocess_clip", "read_rgb", "main"]


def preprocess(img_file, size: int = image_max_height,
               num: int = img_num) -> np.ndarray:
    """file → (1, H, W, 3*num) normalized float32."""
    return normalize_replicate(prepare_canvas(read_rgb(img_file), size),
                               num)[None]


def preprocess_clip(img_files, size: int = image_max_height,
                    num: int = img_num) -> np.ndarray:
    """``num`` frame files → ONE (1, H, W, 3*num) temporal clip."""
    canvases = [prepare_canvas(read_rgb(f), size) for f in img_files]
    return normalize_concat(canvases, num)[None]


def test_img(model_path: Optional[str], img_files: Sequence[str],
             size: int = image_max_height, clip: bool = False,
             dtype: str = "f32", device: str = "cuda") -> List[float]:
    """Score images one at a time (replicate ×img_num), or with
    ``clip=True`` in groups of ``img_num`` distinct frames.  Without a
    ``model_path`` the weights are the seeded init.  ``dtype`` bf16/int8
    applies the serving PTQ to the loaded f32 weights."""
    dtype = canonical_mode(dtype)
    missing = [f for f in img_files if not os.path.isfile(f)]
    if missing:
        raise FileNotFoundError(f"no such image file(s): {missing}")
    if clip and len(img_files) % img_num:
        raise ValueError(f"--clip needs a multiple of img_num={img_num} "
                         f"images, got {len(img_files)}")
    dev = torch.device(device)
    if dev.type == "cuda":
        # f32 parity: cuDNN convolutions would otherwise run in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"To load model from {model_path}")
    model = create_deepfake_model_v4("efficientnet_deepfake_v4",
                                     num_classes=2, in_chans=12,
                                     device=dev)
    if model_path:
        load_checkpoint(model, model_path)
    print("Model loaded!")
    store = quantize_module(model, dtype)
    if store is not None:
        print(f"Quantized weights to {dtype}: {quant_summary(store)}")
    score_fn = make_score_fn(model, store, device=dev)
    scores_out: List[float] = []
    if clip:
        for i in range(0, len(img_files), img_num):
            group = list(img_files[i:i + img_num])
            fake_score = float(score_fn(preprocess_clip(group, size))[0, 0])
            scores_out.append(fake_score)
            print(f"clip {group}'s fake score:{fake_score}")
        return scores_out
    for img_file in img_files:
        fake_score = float(score_fn(preprocess(img_file, size))[0, 0])
        scores_out.append(fake_score)
        print(f"{img_file}'s fake score:{fake_score}")
    return scores_out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="deepfake single-image inference")
    p.add_argument("images", nargs="*")
    p.add_argument("--model-path", default="")
    p.add_argument("--image-size", type=int, default=image_max_height)
    p.add_argument("--clip", action="store_true",
                   help=f"score groups of img_num={img_num} distinct "
                        f"frames as temporal clips instead of replicating "
                        f"each image")
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="post-training quantization of the loaded f32 "
                        "weights (serving/quant.py): f32 = reference "
                        "parity, bf16/int8 = the engine's PTQ serving "
                        "modes")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs the plain PyTorch path")
    args = p.parse_args(argv)
    if not args.images:
        print("Please input your images. e.g. python -m "
              "deepfake_detection_tpu_torch.runners.test image1 image2")
        return
    test_img(args.model_path or None, args.images, size=args.image_size,
             clip=args.clip, dtype=args.dtype, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
