"""Digests of the host augment chain: ``tests/data/host_augment/``.

Not a test module.  Run from the repository root, where Pillow and the JAX
package are installed::

    JAX_PLATFORMS=cpu python tests/torch_host_augment_fixtures.py

``digests.json`` holds the sha256 of the reference's bytes for every case
of :data:`CASES` (an op of Pillow 12 or the JAX package's native warp on
inputs made from a seed with numpy, or the JAX ``transforms_deepfake_
train_v3`` on a seeded clip) and of the first train batches of the JAX
loader under ``scripts/train.sh``'s flags over :func:`make_tree`'s seeded
tree (uint8 images and f32 soft targets), with the Pillow version they
were taken with.  The port computes the same cases with no Pillow and no
JAX (:func:`port_case`, :func:`port_batches`): ``tests/test_torch_host_
augment.py`` holds both sides against the file on the CPU, and
``chip_smoke.py``'s ``host_augment`` phase holds the port against it on
the card's host, which has no Pillow.

The module imports neither Pillow nor JAX at import time; only the
reference functions do.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "data" / "host_augment"
DIGESTS = OUT / "digests.json"

FACTORS = (0.6, 1.4)          # ImageEnhance below and above 1
HUES = (-0.1, 0.2)
BLUR_RADII = (0.5, 1.0, 2.5)
ROTATIONS = (-5, 3)
CHAIN_SEEDS = (0, 1)
WARP_SEEDS = (0, 1, 2, 3)
FRAME = 640                   # the chip tree's frames, cropped to CROP
CROP = 600

#: the loader cases: scripts/train.sh's data and augment flags over
#: make_tree, with and without --host-geom
TREE_HW = 160
TREE_INPUT = (12, 128, 128)
TREE_BATCHES = 3
TRAIN_SH_FLAGS = ["--input-size-v2", "12,128,128", "-b", "3", "--reprob",
                  "0.2", "--remax", "0.05", "--flicker", "0.05",
                  "--rotate-range", "5", "--blur-prob", "0.05",
                  "--mixup", "0.1", "--label-balance", "--workers", "2",
                  "--seed", "42"]
LOADERS = {"train_sh": [], "train_sh_host_geom": ["--host-geom"]}


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@functools.lru_cache(maxsize=1)
def all_colours() -> np.ndarray:
    """Every RGB value once: a 4096 × 4096 × 3 uint8 image (made once,
    read-only)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    out = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    out.setflags(write=False)
    return out


def photo(seed: int, h: int = FRAME, w: int = FRAME) -> np.ndarray:
    """A seeded smooth image with a little noise (structure for the blur,
    the resamplers and the contrast mean)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, 3))
    for c in range(3):
        fx, fy, ph = rng.uniform(0.005, 0.05, 2).tolist() + \
            [rng.uniform(0, 6.3)]
        out[..., c] = 128 + 90 * np.sin(fx * x + ph) * np.cos(fy * y)
    out += rng.normal(0, 12, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def clip(seed: int, n: int = 4) -> List[np.ndarray]:
    return [photo(seed * 16 + i) for i in range(n)]


def _cases() -> Dict[str, Tuple]:
    cases: Dict[str, Tuple] = {"luma": ("luma",), "rgb_to_hsv": ("hsv",),
                               "hsv_to_rgb": ("hsv_rgb",)}
    for f in FACTORS:
        for op in ("brightness", "contrast", "color"):
            cases[f"{op}_{f}"] = (op, f)
        cases[f"contrast_photo_{f}"] = ("contrast_photo", f)
    for hh in HUES:
        cases[f"hue_{hh}"] = ("hue", hh)
    for r in BLUR_RADII:
        cases[f"blur_{r}"] = ("blur", r)
        cases[f"blur_odd_{r}"] = ("blur_odd", r)
    for d in ROTATIONS:
        cases[f"rotate_{d}"] = ("rotate", d)
    cases["flip"] = ("flip",)
    for tw, th in ((533, 427), (901, 901)):
        cases[f"resize_{tw}x{th}"] = ("resize", tw, th)
    for s in WARP_SEEDS:
        cases[f"warp_{s}"] = ("warp", s)
    for fused in (True, False):
        for hh in (0.0, 0.1):
            for s in CHAIN_SEEDS:
                cases[f"chain_fused{int(fused)}_hue{hh}_{s}"] = (
                    "chain", fused, hh, s)
    return cases


CASES = _cases()


def _warp_params(seed: int):
    """The fused chain's draws for a 640² clip into 600², and the clip."""
    from deepfake_detection_tpu_torch.data.transforms import \
        fused_geometric_params
    rng = np.random.default_rng(seed)
    coeffs = fused_geometric_params(FRAME, FRAME, (CROP, CROP), 5,
                                    (2.0 / 3, 3.0 / 2.0), 0.5, rng)
    return coeffs, clip(100 + seed)


def _chain_kw(fused: bool, hh: float) -> dict:
    return dict(img_size=CROP, color_jitter=(0.4, 0.4, 0.4, hh),
                flicker=0.5, rotate_range=5, blur_radius=1, blur_prob=1.0,
                fused_geom=fused)


def reference_case(name: str) -> np.ndarray:
    """The case's bytes from Pillow or the JAX package."""
    from PIL import Image, ImageEnhance, ImageFilter
    kind, *args = CASES[name]
    if kind in ("luma", "hsv"):
        return np.asarray(Image.fromarray(all_colours()).convert(
            "L" if kind == "luma" else "HSV"))
    if kind == "hsv_rgb":
        return np.asarray(Image.fromarray(all_colours(), "HSV").convert(
            "RGB"))
    if kind in ("brightness", "contrast", "color", "contrast_photo"):
        src = photo(1) if kind == "contrast_photo" else all_colours()
        enh = {"brightness": ImageEnhance.Brightness,
               "contrast": ImageEnhance.Contrast,
               "contrast_photo": ImageEnhance.Contrast,
               "color": ImageEnhance.Color}[kind]
        return np.asarray(enh(Image.fromarray(src)).enhance(args[0]))
    if kind == "hue":
        hsv = np.array(Image.fromarray(all_colours()).convert("HSV"),
                       dtype=np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(args[0] * 255)) % 256
        return np.asarray(Image.fromarray(hsv.astype(np.uint8), "HSV")
                          .convert("RGB"))
    if kind in ("blur", "blur_odd"):
        src = photo(2) if kind == "blur" else photo(2, 37, 23)
        return np.asarray(Image.fromarray(src).filter(
            ImageFilter.GaussianBlur(args[0])))
    if kind == "rotate":
        return np.asarray(Image.fromarray(photo(3)).rotate(args[0],
                                                           expand=True))
    if kind == "flip":
        return np.asarray(Image.fromarray(photo(3)).transpose(
            Image.FLIP_LEFT_RIGHT))
    if kind == "resize":
        return np.asarray(Image.fromarray(photo(4)).resize(
            (args[0], args[1]), Image.BILINEAR))
    if kind == "warp":
        from deepfake_detection_tpu.data import native as j_native
        coeffs, frames = _warp_params(args[0])
        return j_native.warp_affine_batch(frames, coeffs, (CROP, CROP),
                                          packed=True)
    if kind == "chain":
        from deepfake_detection_tpu.data import transforms_factory as j_tff
        fused, hh, s = args
        t = j_tff.transforms_deepfake_train_v3(**_chain_kw(fused, hh))
        return np.asarray(t(clip(200 + s), np.random.default_rng(s)))
    raise KeyError(name)


def port_case(name: str) -> np.ndarray:
    """The case's bytes from the port (no Pillow, no JAX)."""
    from deepfake_detection_tpu_torch.data import imaging, native
    from deepfake_detection_tpu_torch.data import transforms_factory as tff
    kind, *args = CASES[name]
    if kind == "luma":
        return imaging.luma(all_colours())
    if kind == "hsv":
        return imaging.rgb_to_hsv(all_colours())
    if kind == "hsv_rgb":
        return imaging.hsv_to_rgb(all_colours())
    if kind in ("brightness", "contrast", "color", "contrast_photo"):
        src = photo(1) if kind == "contrast_photo" else all_colours()
        op = "contrast" if kind == "contrast_photo" else kind
        return getattr(imaging, op)(src, args[0])
    if kind == "hue":
        return imaging.hue(all_colours(), args[0])
    if kind in ("blur", "blur_odd"):
        src = photo(2) if kind == "blur" else photo(2, 37, 23)
        return imaging.gaussian_blur(src, args[0])
    if kind == "rotate":
        return imaging.rotate(photo(3), args[0])
    if kind == "flip":
        return imaging.flip_left_right(photo(3))
    if kind == "resize":
        return imaging.resize_bilinear(photo(4), (args[0], args[1]))
    if kind == "warp":
        coeffs, frames = _warp_params(args[0])
        return native.warp_affine_batch(frames, coeffs, (CROP, CROP),
                                        packed=True)
    if kind == "chain":
        fused, hh, s = args
        t = tff.transforms_deepfake_train_v3(**_chain_kw(fused, hh))
        return np.asarray(t(clip(200 + s), np.random.default_rng(s)))
    raise KeyError(name)


def make_tree(root) -> str:
    """A seeded clip tree of ``.npy`` frames at ``TREE_HW``²: 6 real and 10
    fake clips of 2 to 6 frames, and the ``name:num`` lists."""
    root = Path(root)
    rng = np.random.default_rng(15)
    for kind, n in (("real", 6), ("fake", 10)):
        lines = []
        for c in range(n):
            nf = (2, 3, 4, 5, 6, 4)[c % 6]
            d = root / kind / f"clip{c:03d}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(nf):
                q = rng.integers(0, 256, (TREE_HW // 4, TREE_HW // 4, 3),
                                 dtype=np.uint8)
                frame = np.repeat(np.repeat(q, 4, 0), 4, 1)
                np.save(d / f"{i}.npy", frame)
            lines.append(f"clip{c:03d}:{nf}\n")
        (root / f"{kind}_list.txt").write_text("".join(lines))
    return str(root)


def _batch_digests(batches) -> List[List[str]]:
    return [[sha(np.asarray(x, np.uint8)), sha(np.asarray(y, np.float32))]
            for x, y in batches]


def reference_batches(root: str, extra: List[str]) -> List[List[str]]:
    """The JAX runner's train loader (host chain) under the flags: the
    first ``TREE_BATCHES`` host batches' digests."""
    from PIL import Image

    from deepfake_detection_tpu import config as j_config
    from deepfake_detection_tpu.data import dataset as j_ds
    from deepfake_detection_tpu.runners import train as j_runner
    cfg = j_config.TrainConfig.from_args(TRAIN_SH_FLAGS + extra
                                         + ["--data", root])
    train, _ = j_runner.build_datasets(cfg, TREE_INPUT)
    # the JAX dataset decodes the listed <i>.jpg; the tree holds the
    # frames as the <i>.npy beside that path, which the port reads
    load = j_ds._load_images
    j_ds._load_images = lambda paths: [
        Image.fromarray(np.load(os.path.splitext(p)[0] + ".npy"))
        for p in paths]
    try:
        return _reference_batches(cfg, train)
    finally:
        j_ds._load_images = load


def _reference_batches(cfg, train) -> List[List[str]]:
    import jax.numpy as jnp

    from deepfake_detection_tpu.data import loader as j_loader
    from deepfake_detection_tpu.data import mixup as j_mixup
    jl = j_loader.create_deepfake_loader_v3(
        train, TREE_INPUT, 3, is_training=True, re_prob=cfg.reprob,
        re_max=cfg.remax, color_jitter=cfg.color_jitter,
        collate_mixup=j_mixup.FastCollateMixup(cfg.mixup, cfg.smoothing,
                                               cfg.num_classes),
        flicker=cfg.flicker, rotate_range=cfg.rotate_range, blur_radius=1,
        blur_prob=cfg.blur_prob,
        device_color_jitter=not cfg.host_color_jitter,
        fused_geom=not cfg.host_geom, augment_device=False,
        dtype=jnp.float32, num_workers=cfg.workers, seed=cfg.seed)
    jl.set_epoch(0)
    out = []
    for x, y in jl.loader:
        out.append((x, y))
        if len(out) == TREE_BATCHES:
            break
    return _batch_digests(out)


def port_batches(root: str, extra: List[str]) -> List[List[str]]:
    """The port runner's train loader under the same flags (its host
    batches, before the device)."""
    import torch
    from deepfake_detection_tpu_torch.runners import train as runner
    cfg = runner.parse_args(TRAIN_SH_FLAGS + extra + ["--data", root,
                                                      "--device", "cpu"])
    tl, _ = runner.build_loaders(cfg, torch.device("cpu"),
                                 *runner.build_datasets(cfg))
    tl.set_epoch(0)
    out = []
    for hb in tl.loader:
        out.append((hb.images.numpy(), hb.targets.numpy()))
        if len(out) == TREE_BATCHES:
            break
    return _batch_digests(out)


def load_digests() -> dict:
    return json.loads(DIGESTS.read_text())


def main() -> int:
    import tempfile

    import PIL
    OUT.mkdir(parents=True, exist_ok=True)
    cases = {name: sha(reference_case(name)) for name in CASES}
    with tempfile.TemporaryDirectory() as tmp:
        root = make_tree(os.path.join(tmp, "tree"))
        loaders = {k: reference_batches(root, extra)
                   for k, extra in LOADERS.items()}
    DIGESTS.write_text(json.dumps(
        {"pillow": PIL.__version__, "cases": cases, "loaders": loaders},
        indent=1, sort_keys=True) + "\n")
    print(f"wrote {DIGESTS}: {len(cases)} cases, "
          f"{sum(len(v) for v in loaders.values())} batches")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    sys.exit(main())
