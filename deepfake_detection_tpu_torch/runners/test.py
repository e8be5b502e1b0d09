"""Single-image inference runner.

Counterpart of ``deepfake_detection_tpu/runners/test.py``: build the
flagship ``efficientnet_deepfake_v4``, load a checkpoint, preprocess each
image (aspect-preserving resize + center pad to the canvas, normalize,
replicate ×4 → 12 channels, or ``--clip``: 4 distinct frames concatenated)
and print the softmax fake score ``scores[:, 0]``.

Usage::

    python -m deepfake_detection_tpu_torch.runners.test img1.npy img2.png \\
        [--model-path PATH] [--image-size 600] [--clip] [--device cuda]

``.npy`` files hold uint8 HWC RGB frames and are read with numpy; other
formats need Pillow.  ``--model-path`` is a torch file with timm's keys.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import create_deepfake_model_v4, load_checkpoint
from ..params import (image_max_height, img_num, make_score_fn,
                      normalize_concat, normalize_replicate, prepare_canvas)

__all__ = ["test_img", "preprocess", "preprocess_clip", "read_rgb", "main"]


def read_rgb(img_file) -> np.ndarray:
    """uint8 HWC RGB frame from a ``.npy`` file (numpy) or any format
    Pillow reads."""
    if str(img_file).endswith(".npy"):
        img = np.load(img_file, allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{img_file}: expected uint8 (H, W, 3), got "
                             f"{img.dtype} {img.shape}")
        return img
    try:
        from PIL import Image
    except ImportError as e:
        ext = os.path.splitext(str(img_file))[1] or "(no extension)"
        raise ImportError(f"reading {ext} images needs Pillow, which is not "
                          f"installed; .npy frames need only numpy") from e
    return np.asarray(Image.open(img_file).convert("RGB"), np.uint8)


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
    ``model_path`` the weights are the seeded init."""
    if dtype not in ("f32", "float32"):
        raise NotImplementedError(
            f"--dtype {dtype}: only f32 is ported (the bf16/int8 PTQ of "
            "serving/quant.py is a later slice)")
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
    score_fn = make_score_fn(model)
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
    p.add_argument("--dtype", default="f32", choices=["f32"],
                   help="weight precision (only f32 is ported)")
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
