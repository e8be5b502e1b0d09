"""Digests of AugMix's ops and policies: ``tests/data/augmix/``.

Not a test module.  Run from the repository root, where Pillow and the JAX
package are installed::

    JAX_PLATFORMS=cpu python tests/torch_augmix_fixtures.py

``digests.json`` holds the sha256 of the reference's bytes for every case
of :data:`CASES`: an op of Pillow 12 (``ImageOps``' tables, histogram
ops, ``ImageEnhance.Sharpness``, ``Image.blend``, ``Image.transform``
and ``Image.rotate`` with ``BILINEAR`` and ``BICUBIC`` and a fill) on
inputs made from a seed with numpy, or a policy of the JAX package's
``data/auto_augment.py`` (AugMix, RandAugment, AutoAugment) on seeded
frames and generators; and of the first train batches of the JAX loader
over ``torch_host_augment_fixtures.make_tree``'s tree under
``scripts/train.sh``'s flags with ``--mixup 0 --aug-splits 3 --resplit``
(uint8 images, split-major, and the tiled labels).  The port computes the
same cases with no Pillow and no JAX (:func:`port_case`,
:func:`port_batches`): ``tests/test_torch_augmix.py`` holds both sides
against the file on the CPU, and ``chip_smoke.py``'s ``augmix`` phase
holds the port against it on the card's host, which has no Pillow.

A table op (``posterize``, ``solarize``, ``solarize_add``, ``invert``)
runs over all 2²⁴ colours at one argument, and over the 256-value ramp of
every band at every argument it can take (the ``*_tables`` cases).

The module imports neither Pillow nor JAX at import time; only the
reference functions do.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_host_augment_fixtures as hx  # noqa: E402

OUT = HERE / "data" / "augmix"
DIGESTS = OUT / "digests.json"

FILL = (128, 128, 128)                    # the policies' fill colour
BILINEAR, BICUBIC = 2, 3                  # Pillow's codes
#: frames the image ops sweep: (height, width); odd, even, tiny, square
FRAMES = {"odd": (37, 23), "even": (64, 96), "tiny": (2, 5), "one": (1, 1),
          "square": (48, 48)}
SHARPNESS = (-0.3, 0.1, 0.55, 1.0, 1.45, 1.9, 2.5)
BLENDS = (0.0, 0.25, 0.6180339887, 1.0)
ANGLES = (-30.0, -9.5, -0.3, 0.7, 5.0, 12.25, 29.9, 90.0, 180.0, 270.0)
SHEARS = (-0.3, -0.11, 0.05, 0.3)
TRANSLATES = (-0.45, -0.1, 0.033, 0.45)     # a fraction of the extent
TRANSLATES_ABS = (-100.0, -3.3, 7.5, 250.0)
POSTERIZE_BITS = tuple(range(9))
SOLARIZE_THRESHOLDS = tuple(range(257))
SOLARIZE_ADDS = tuple(range(111))
#: the policies: (name, config string, constructor)
POLICIES = {"augmix": ("augmix-m3-w3", "augment_and_mix_transform"),
            "augmix_m5_w4_d2": ("augmix-m5-w4-d2-mstd0.5",
                                "augment_and_mix_transform"),
            "rand_inc": ("rand-m9-mstd0.5-inc1", "rand_augment_transform"),
            "rand_weighted": ("rand-m9-n3-w0-mstd101",
                              "rand_augment_transform"),
            "aa_v0": ("v0", "auto_augment_transform"),
            "aa_original": ("original-mstd0.5", "auto_augment_transform"),
            "aa_originalr": ("originalr", "auto_augment_transform")}
POLICY_SEEDS = (0, 1, 2, 3)
AUGMIX_FRAME = 600                        # the flagship's crop
#: scripts/train.sh's flags with AugMix in place of mixup, on the tree
AUGMIX_FLAGS = ["--mixup", "0", "--aug-splits", "3", "--jsd", "--resplit"]
TREE_BATCHES = 3


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def frame(kind: str, seed: int) -> np.ndarray:
    h, w = FRAMES[kind]
    return hx.photo(seed, h, w)


def degenerate(kind: str) -> np.ndarray:
    """Frames whose histograms take the ops' special branches."""
    rng = np.random.default_rng(9)
    a = hx.photo(5, 31, 40)
    if kind == "constant_band":          # autocontrast: hi <= lo
        a[..., 1] = 77
    elif kind == "two_values":           # equalize: one step
        a[..., 0] = rng.integers(0, 2, a.shape[:2]) * 200
    elif kind == "few_pixels":           # equalize: step 1, table > 255
        a = rng.integers(0, 256, (19, 17, 3), dtype=np.uint8)
        a[:10] = 250
    elif kind == "flat":                 # every band one value
        a[...] = (3, 200, 128)
    return a


DEGENERATE = ("constant_band", "two_values", "few_pixels", "flat")


def ramp() -> np.ndarray:
    """Every value in every band: a (1, 256, 3) frame."""
    return np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 3, 2)


def _cases() -> Dict[str, Tuple]:
    cases: Dict[str, Tuple] = {}
    # each table op over every colour at one argument (the CPU tests take
    # every argument); the table sweeps below cover every argument
    for op, arg in (("posterize", 3), ("solarize", 128),
                    ("solarize_add", 37), ("invert", None)):
        cases[f"{op}_colours"] = ("colours", op, arg)
    for op in ("posterize", "solarize", "solarize_add"):
        cases[f"{op}_tables"] = ("tables", op)
    for kind in FRAMES:
        for op in ("autocontrast", "equalize"):
            cases[f"{op}_{kind}"] = ("hist", op, kind)
        cases[f"sharpness_{kind}"] = ("sharpness", kind)
        cases[f"blend_{kind}"] = ("blend", kind)
        for res in (BILINEAR, BICUBIC):
            for fam in ("rotate", "shear", "translate"):
                cases[f"{fam}_{kind}_{res}"] = ("affine", fam, kind, res)
    for kind in DEGENERATE:
        for op in ("autocontrast", "equalize"):
            cases[f"{op}_{kind}"] = ("hist_degenerate", op, kind)
    cases["sharpness_colours"] = ("sharpness_colours",)
    for name in POLICIES:
        for s in POLICY_SEEDS:
            cases[f"policy_{name}_{s}"] = ("policy", name, s)
    for s in (0, 1):
        cases[f"augmix_600_{s}"] = ("augmix_600", s)
    return cases


CASES = _cases()


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

def _table_args(op: str):
    return {"posterize": POSTERIZE_BITS, "solarize": SOLARIZE_THRESHOLDS,
            "solarize_add": SOLARIZE_ADDS}[op]


def _affine_sweep(fam: str, w: int, h: int):
    """(kind, argument) of one family's sweep."""
    if fam == "rotate":
        return [("rotate", d) for d in ANGLES]
    if fam == "shear":
        return [(k, f) for k in ("shear_x", "shear_y") for f in SHEARS]
    return ([("translate_x", p * w) for p in TRANSLATES]
            + [("translate_y", p * h) for p in TRANSLATES]
            + [("translate_x", p) for p in TRANSLATES_ABS])


_MATRIX = {"shear_x": lambda f: (1, f, 0, 0, 1, 0),
           "shear_y": lambda f: (1, 0, 0, f, 1, 0),
           "translate_x": lambda p: (1, 0, p, 0, 1, 0),
           "translate_y": lambda p: (1, 0, 0, 0, 1, p)}


def _policy_input(name: str, s: int):
    kind = ("odd", "even", "square", "odd")[s]
    return frame(kind, 40 + s), np.random.default_rng(1000 + s)


def reference_case(name: str) -> np.ndarray:
    """The case's bytes from Pillow or the JAX package."""
    from PIL import Image, ImageEnhance, ImageOps
    spec = CASES[name]
    kind = spec[0]

    def lut_op(op, img, arg):
        if op == "posterize":
            return ImageOps.posterize(img, arg)
        if op == "solarize":
            return ImageOps.solarize(img, arg)
        if op == "solarize_add":
            lut = [min(255, i + arg) if i < 128 else i for i in range(256)]
            return img.point(lut * 3)
        return ImageOps.invert(img)

    if kind == "colours":
        return np.asarray(lut_op(spec[1], Image.fromarray(hx.all_colours()),
                                 spec[2]))
    if kind == "tables":
        img = Image.fromarray(ramp())
        return np.stack([np.asarray(lut_op(spec[1], img, a))
                         for a in _table_args(spec[1])])
    if kind in ("hist", "hist_degenerate"):
        src = frame(spec[2], 1) if kind == "hist" else degenerate(spec[2])
        op = ImageOps.autocontrast if spec[1] == "autocontrast" \
            else ImageOps.equalize
        return np.asarray(op(Image.fromarray(src)))
    if kind == "sharpness":
        img = Image.fromarray(frame(spec[1], 2))
        return np.stack([np.asarray(ImageEnhance.Sharpness(img).enhance(f))
                         for f in SHARPNESS])
    if kind == "sharpness_colours":
        return np.asarray(ImageEnhance.Sharpness(
            Image.fromarray(hx.all_colours())).enhance(1.3))
    if kind == "blend":
        a, b = frame(spec[1], 3), frame(spec[1], 4)
        return np.stack([np.asarray(Image.blend(
            Image.fromarray(a), Image.fromarray(b), al)) for al in BLENDS])
    if kind == "affine":
        _, fam, fk, res = spec
        img = Image.fromarray(frame(fk, 6))
        outs = []
        for op, arg in _affine_sweep(fam, img.size[0], img.size[1]):
            if op == "rotate":
                outs.append(img.rotate(arg, resample=res, fillcolor=FILL))
            else:
                outs.append(img.transform(img.size, Image.AFFINE,
                                          _MATRIX[op](arg), resample=res,
                                          fillcolor=FILL))
        return np.stack([np.asarray(o) for o in outs])
    if kind == "policy":
        from deepfake_detection_tpu.data import auto_augment as ja
        cfg, ctor = POLICIES[spec[1]]
        a, rng = _policy_input(spec[1], spec[2])
        out = np.asarray(getattr(ja, ctor)(cfg)(Image.fromarray(a), rng))
        return np.concatenate([out.ravel(), _rng_tail(rng)])
    if kind == "augmix_600":
        from deepfake_detection_tpu.data import auto_augment as ja
        a = hx.photo(70 + spec[1], AUGMIX_FRAME, AUGMIX_FRAME)
        rng = np.random.default_rng(spec[1])
        return np.asarray(ja.augment_and_mix_transform("augmix-m3-w3")(
            Image.fromarray(a), rng))
    raise KeyError(name)


def _rng_tail(rng) -> np.ndarray:
    """The generator's next draws as bytes: a call that drew out of order
    leaves another state."""
    return rng.integers(0, 256, 16, dtype=np.uint8)


def port_case(name: str) -> np.ndarray:
    """The case's bytes from the port (no Pillow, no JAX)."""
    from deepfake_detection_tpu_torch.data import auto_augment as ta
    from deepfake_detection_tpu_torch.data import imaging
    spec = CASES[name]
    kind = spec[0]

    def lut_op(op, a, arg):
        if op == "invert":
            return imaging.invert(a)
        return getattr(imaging, op)(a, arg)

    if kind == "colours":
        return lut_op(spec[1], hx.all_colours(), spec[2])
    if kind == "tables":
        return np.stack([lut_op(spec[1], ramp(), a)
                         for a in _table_args(spec[1])])
    if kind in ("hist", "hist_degenerate"):
        src = frame(spec[2], 1) if kind == "hist" else degenerate(spec[2])
        return getattr(imaging, spec[1])(src)
    if kind == "sharpness":
        a = frame(spec[1], 2)
        return np.stack([imaging.sharpness(a, f) for f in SHARPNESS])
    if kind == "sharpness_colours":
        return imaging.sharpness(hx.all_colours(), 1.3)
    if kind == "blend":
        a, b = frame(spec[1], 3), frame(spec[1], 4)
        return np.stack([imaging.blend(a, b, al) for al in BLENDS])
    if kind == "affine":
        _, fam, fk, res = spec
        a = frame(fk, 6)
        outs = []
        for op, arg in _affine_sweep(fam, a.shape[1], a.shape[0]):
            if op == "rotate":
                outs.append(imaging.rotate_fill(a, arg, res, FILL))
            else:
                outs.append(imaging.affine(a, _MATRIX[op](arg), res, FILL))
        return np.stack(outs)
    if kind == "policy":
        cfg, ctor = POLICIES[spec[1]]
        a, rng = _policy_input(spec[1], spec[2])
        out = np.asarray(getattr(ta, ctor)(cfg)(a, rng))
        return np.concatenate([out.ravel(), _rng_tail(rng)])
    if kind == "augmix_600":
        a = hx.photo(70 + spec[1], AUGMIX_FRAME, AUGMIX_FRAME)
        return ta.augment_and_mix_transform("augmix-m3-w3")(
            a, np.random.default_rng(spec[1]))
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _batch_digests(batches) -> List[List[str]]:
    return [[sha(np.asarray(x, np.uint8)), sha(np.asarray(y, np.int64))]
            for x, y in batches]


def reference_batches(root: str) -> List[List[str]]:
    """The JAX loader (host chain, ``num_aug_splits`` 3, ``re_split``)
    under the flags: the first ``TREE_BATCHES`` host batches' digests."""
    import jax.numpy as jnp
    from PIL import Image

    from deepfake_detection_tpu import config as j_config
    from deepfake_detection_tpu.data import dataset as j_ds
    from deepfake_detection_tpu.data import loader as j_loader
    from deepfake_detection_tpu.runners import train as j_runner
    cfg = j_config.TrainConfig.from_args(hx.TRAIN_SH_FLAGS + AUGMIX_FLAGS
                                         + ["--data", root])
    train, _ = j_runner.build_datasets(cfg, hx.TREE_INPUT)
    load = j_ds._load_images
    j_ds._load_images = lambda paths: [
        Image.fromarray(np.load(os.path.splitext(p)[0] + ".npy"))
        for p in paths]
    try:
        jl = j_loader.create_deepfake_loader_v3(
            train, hx.TREE_INPUT, 3, is_training=True, re_prob=cfg.reprob,
            re_max=cfg.remax, re_split=cfg.resplit,
            color_jitter=cfg.color_jitter, num_aug_splits=cfg.aug_splits,
            flicker=cfg.flicker, rotate_range=cfg.rotate_range,
            blur_radius=1, blur_prob=cfg.blur_prob, dtype=jnp.float32,
            num_workers=cfg.workers, seed=cfg.seed)
        jl.set_epoch(0)
        out = []
        for x, y in jl.loader:
            out.append((x, y))
            if len(out) == TREE_BATCHES:
                break
    finally:
        j_ds._load_images = load
    return _batch_digests(out)


def port_batches(root: str) -> List[List[str]]:
    """The port runner's train loader under the same flags (its host
    batches, before the device)."""
    import torch
    from deepfake_detection_tpu_torch.runners import train as runner
    cfg = runner.parse_args(hx.TRAIN_SH_FLAGS + AUGMIX_FLAGS
                            + ["--data", root, "--device", "cpu"])
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


def reference_digests(root: str) -> dict:
    import PIL
    return {"pillow": PIL.__version__,
            "cases": {name: sha(reference_case(name)) for name in CASES},
            "loaders": {"augmix_resplit": reference_batches(root)}}


def main() -> int:
    import tempfile
    OUT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = reference_digests(hx.make_tree(os.path.join(tmp, "tree")))
    DIGESTS.write_text(json.dumps(d, indent=1, sort_keys=True) + "\n")
    print(f"wrote {DIGESTS}: {len(d['cases'])} cases, "
          f"{len(d['loaders']['augmix_resplit'])} batches")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    sys.exit(main())
