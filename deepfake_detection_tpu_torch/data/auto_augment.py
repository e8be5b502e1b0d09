"""AutoAugment, RandAugment and AugMix on uint8 arrays, without Pillow.

Counterpart of ``deepfake_detection_tpu/data/auto_augment.py``, which
runs timm's op pool through Pillow: the same 16 ops (``NAME_TO_OP``), the
magnitude → argument maps (``LEVEL_TO_ARG``), :class:`AugmentOp`, the
AutoAugment policies (v0, original, originalr), :class:`AutoAugment`,
:class:`RandAugment`, :class:`AugMixAugment` and the config-string parsers.
An op takes and returns a uint8 ``(H, W, 3)`` array (a channel slice of a
packed clip is read in place); the pixels are Pillow 12's, computed by
``data/imaging.py`` over ``native/imaging.cc``.

Every draw comes from the ``numpy.random.Generator`` passed to a call, in
the JAX module's order, so a call with the same generator state gives the
same bytes: a geometric op draws its resampler (``BILINEAR`` or
``BICUBIC``) only when no ``interpolation`` hparam fixed it; an op of
probability below 1 draws its coin first; the magnitude noise is
``uniform(0, m)`` under ``mstd=inf`` (AugMix's default) and ``normal(m,
mstd)`` otherwise; ``_randomly_negate`` draws after the magnitude; AugMix
draws its Dirichlet weights, then its Beta blend, then each chain's depth
and ops.  The JAX module's quirks are kept: ``AugMixAugment`` parses
``blended`` and never uses it, and its float mixture is truncated to uint8
before the blend.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import imaging

__all__ = ["AutoAugment", "RandAugment", "AugMixAugment",
           "auto_augment_transform", "rand_augment_transform",
           "augment_and_mix_transform", "AugmentOp", "NAME_TO_OP",
           "LEVEL_TO_ARG"]

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)
_INTERP = (imaging.BILINEAR, imaging.BICUBIC)
# Pillow's codes for the hparams' interpolation names (LANCZOS is 1)
_PIL_INTERP = {"nearest": imaging.NEAREST, "bilinear": imaging.BILINEAR,
               "bicubic": imaging.BICUBIC, "lanczos": 1}


def pil_interp(method: str) -> int:
    return _PIL_INTERP.get(method, imaging.BILINEAR)


def _interpolation(kwargs: Dict, rng: np.random.Generator):
    interp = kwargs.pop("resample", _INTERP)
    if isinstance(interp, (list, tuple)):
        return interp[rng.integers(len(interp))]
    return interp


def _size(img: np.ndarray) -> Tuple[int, int]:
    """Pillow's ``img.size``: (width, height)."""
    return img.shape[1], img.shape[0]


# ---------------------------------------------------------------------------
# Image ops
# ---------------------------------------------------------------------------

def _transform(img, matrix, rng, kw):
    return imaging.affine(img, matrix, _interpolation(kw, rng),
                          kw.get("fillcolor"))


def shear_x(img, factor, rng, **kw):
    return _transform(img, (1, factor, 0, 0, 1, 0), rng, kw)


def shear_y(img, factor, rng, **kw):
    return _transform(img, (1, 0, 0, factor, 1, 0), rng, kw)


def translate_x_rel(img, pct, rng, **kw):
    pixels = pct * _size(img)[0]
    return _transform(img, (1, 0, pixels, 0, 1, 0), rng, kw)


def translate_y_rel(img, pct, rng, **kw):
    pixels = pct * _size(img)[1]
    return _transform(img, (1, 0, 0, 0, 1, pixels), rng, kw)


def translate_x_abs(img, pixels, rng, **kw):
    return _transform(img, (1, 0, pixels, 0, 1, 0), rng, kw)


def translate_y_abs(img, pixels, rng, **kw):
    return _transform(img, (1, 0, 0, 0, 1, pixels), rng, kw)


def rotate(img, degrees, rng, **kw):
    return imaging.rotate_fill(img, degrees, _interpolation(kw, rng),
                               kw.get("fillcolor"))


def auto_contrast(img, rng, **kw):
    return imaging.autocontrast(img)


def invert(img, rng, **kw):
    return imaging.invert(img)


def equalize(img, rng, **kw):
    return imaging.equalize(img)


def solarize(img, thresh, rng, **kw):
    return imaging.solarize(img, thresh)


def solarize_add(img, add, rng, thresh=128, **kw):
    return imaging.solarize_add(img, add, thresh)


def posterize(img, bits, rng, **kw):
    if bits >= 8:
        return img
    return imaging.posterize(img, bits)


def contrast(img, factor, rng, **kw):
    return imaging.contrast(img, factor)


def color(img, factor, rng, **kw):
    return imaging.color(img, factor)


def brightness(img, factor, rng, **kw):
    return imaging.brightness(img, factor)


def sharpness(img, factor, rng, **kw):
    return imaging.sharpness(img, factor)


def _randomly_negate(v, rng) -> float:
    return -v if rng.random() > 0.5 else v


# ---------------------------------------------------------------------------
# Level → arg maps
# ---------------------------------------------------------------------------

def _rotate_level(level, rng, hp):
    return (_randomly_negate((level / _MAX_LEVEL) * 30.0, rng),)


def _enhance_level(level, rng, hp):
    return ((level / _MAX_LEVEL) * 1.8 + 0.1,)


def _enhance_increasing_level(level, rng, hp):
    return (1.0 + _randomly_negate((level / _MAX_LEVEL) * 0.9, rng),)


def _shear_level(level, rng, hp):
    return (_randomly_negate((level / _MAX_LEVEL) * 0.3, rng),)


def _translate_abs_level(level, rng, hp):
    return (_randomly_negate(
        (level / _MAX_LEVEL) * float(hp.get("translate_const", 250)), rng),)


def _translate_rel_level(level, rng, hp):
    return (_randomly_negate(
        (level / _MAX_LEVEL) * hp.get("translate_pct", 0.45), rng),)


def _posterize_level(level, rng, hp):
    return (int((level / _MAX_LEVEL) * 4),)


def _posterize_increasing_level(level, rng, hp):
    return (4 - int((level / _MAX_LEVEL) * 4),)


def _posterize_original_level(level, rng, hp):
    return (int((level / _MAX_LEVEL) * 4) + 4,)


def _solarize_level(level, rng, hp):
    return (int((level / _MAX_LEVEL) * 256),)


def _solarize_increasing_level(level, rng, hp):
    return (256 - int((level / _MAX_LEVEL) * 256),)


def _solarize_add_level(level, rng, hp):
    return (int((level / _MAX_LEVEL) * 110),)


def _none(level, rng, hp):
    return ()


LEVEL_TO_ARG: Dict[str, Callable] = {
    "AutoContrast": _none, "Equalize": _none, "Invert": _none,
    "Rotate": _rotate_level,
    "Posterize": _posterize_level,
    "PosterizeIncreasing": _posterize_increasing_level,
    "PosterizeOriginal": _posterize_original_level,
    "Solarize": _solarize_level,
    "SolarizeIncreasing": _solarize_increasing_level,
    "SolarizeAdd": _solarize_add_level,
    "Color": _enhance_level, "ColorIncreasing": _enhance_increasing_level,
    "Contrast": _enhance_level, "ContrastIncreasing": _enhance_increasing_level,
    "Brightness": _enhance_level,
    "BrightnessIncreasing": _enhance_increasing_level,
    "Sharpness": _enhance_level,
    "SharpnessIncreasing": _enhance_increasing_level,
    "ShearX": _shear_level, "ShearY": _shear_level,
    "TranslateX": _translate_abs_level, "TranslateY": _translate_abs_level,
    "TranslateXRel": _translate_rel_level,
    "TranslateYRel": _translate_rel_level,
}

NAME_TO_OP: Dict[str, Callable] = {
    "AutoContrast": auto_contrast, "Equalize": equalize, "Invert": invert,
    "Rotate": rotate,
    "Posterize": posterize, "PosterizeIncreasing": posterize,
    "PosterizeOriginal": posterize,
    "Solarize": solarize, "SolarizeIncreasing": solarize,
    "SolarizeAdd": solarize_add,
    "Color": color, "ColorIncreasing": color,
    "Contrast": contrast, "ContrastIncreasing": contrast,
    "Brightness": brightness, "BrightnessIncreasing": brightness,
    "Sharpness": sharpness, "SharpnessIncreasing": sharpness,
    "ShearX": shear_x, "ShearY": shear_y,
    "TranslateX": translate_x_abs, "TranslateY": translate_y_abs,
    "TranslateXRel": translate_x_rel, "TranslateYRel": translate_y_rel,
}

_GEOMETRIC = {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY",
              "TranslateXRel", "TranslateYRel"}


class AugmentOp:
    """One (op, probability, magnitude) triple."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 hparams: Optional[Dict] = None):
        hparams = hparams or {}
        self.name = name
        self.aug_fn = NAME_TO_OP[name]
        self.level_fn = LEVEL_TO_ARG[name]
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = dict(hparams)
        self.kwargs: Dict[str, Any] = {}
        if name in _GEOMETRIC:
            self.kwargs["fillcolor"] = hparams.get("img_mean", _FILL)
            if "interpolation" in hparams:
                self.kwargs["resample"] = pil_interp(hparams["interpolation"])
        # magnitude noise: mstd sampled per call; mstd=inf → uniform
        self.magnitude_std = self.hparams.get("magnitude_std", 0)
        self.magnitude_max = self.hparams.get("magnitude_max", _MAX_LEVEL)

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        if self.prob < 1.0 and rng.random() > self.prob:
            return img
        magnitude = self.magnitude
        if self.magnitude_std:
            if self.magnitude_std == float("inf"):
                magnitude = rng.uniform(0, magnitude)
            elif self.magnitude_std > 0:
                magnitude = rng.normal(magnitude, self.magnitude_std)
        magnitude = max(0.0, min(float(self.magnitude_max), magnitude))
        args = self.level_fn(magnitude, rng, self.hparams)
        return self.aug_fn(img, *args, rng, **dict(self.kwargs))


# ---------------------------------------------------------------------------
# AutoAugment policies (policy data from the AutoAugment paper / TF impl)
# ---------------------------------------------------------------------------

def _policy_v0() -> List[List[Tuple[str, float, int]]]:
    return [
        [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
        [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
        [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
        [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
        [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
        [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
        [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
        [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
        [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
        [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
        [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
        [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
        [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
        [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
        [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
        [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
        [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
        [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
        [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
        [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
        [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
        [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
        [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
        [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
        [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
    ]


def _policy_original() -> List[List[Tuple[str, float, int]]]:
    return [
        [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
        [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
        [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
        [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
        [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
        [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
        [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
        [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
        [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
        [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
        [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
        [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
        [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
        [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
        [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
        [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
        [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
        [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
        [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
        [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
        [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
        [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
        [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
        [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
        [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    ]


def _policy_originalr() -> List[List[Tuple[str, float, int]]]:
    # 'original' with research-style increasing posterize
    return [[("PosterizeIncreasing", p, m) if n == "PosterizeOriginal"
             else (n, p, m) for n, p, m in sub] for sub in _policy_original()]


_POLICIES = {"v0": _policy_v0, "original": _policy_original,
             "originalr": _policy_originalr}


class AutoAugment:
    """Pick one random sub-policy per image and apply it."""

    def __init__(self, policy: str = "v0", hparams: Optional[Dict] = None):
        table = _POLICIES[policy]()
        self.policy = [[AugmentOp(n, p, m, hparams) for n, p, m in sub]
                       for sub in table]

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        sub = self.policy[rng.integers(len(self.policy))]
        for op in sub:
            img = op(img, rng)
        return img


def auto_augment_transform(config_str: str, hparams: Optional[Dict] = None
                           ) -> AutoAugment:
    """Parse e.g. ``'original-mstd0.5'``."""
    config = config_str.split("-")
    policy = config[0]
    hparams = dict(hparams or {})
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            hparams["magnitude_std"] = float(val)
    return AutoAugment(policy, hparams)


# ---------------------------------------------------------------------------
# RandAugment
# ---------------------------------------------------------------------------

_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]

_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

# timm's _RAND_CHOICE_WEIGHTS_0, by name
_RAND_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2, "TranslateXRel": 0.1,
    "TranslateYRel": 0.1, "Color": 0.025, "Sharpness": 0.025,
    "AutoContrast": 0.025, "Solarize": 0.005, "SolarizeAdd": 0.005,
    "Contrast": 0.005, "Brightness": 0.005, "Equalize": 0.005,
    "Posterize": 0.0, "Invert": 0.0,
}


class RandAugment:
    """Apply ``num_layers`` ops drawn (optionally weighted) from the
    pool."""

    def __init__(self, ops: Sequence[AugmentOp], num_layers: int = 2,
                 choice_weights: Optional[np.ndarray] = None):
        self.ops = list(ops)
        self.num_layers = num_layers
        self.choice_weights = choice_weights

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        picks = rng.choice(
            len(self.ops), self.num_layers,
            replace=self.choice_weights is None, p=self.choice_weights)
        for i in picks:
            img = self.ops[i](img, rng)
        return img


def rand_augment_transform(config_str: str, hparams: Optional[Dict] = None
                           ) -> RandAugment:
    """Parse e.g. ``'rand-m9-mstd0.5-inc1'``."""
    magnitude = _MAX_LEVEL
    num_layers = 2
    hparams = dict(hparams or {})
    transforms = _RAND_TRANSFORMS
    weight_idx = None
    config = config_str.split("-")
    if config[0] != "rand":
        raise ValueError(f"a RandAugment config starts with 'rand', got "
                         f"{config_str!r}")
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            v = float(val)
            if v > 100:
                v = float("inf")
            hparams["magnitude_std"] = v
        elif key == "mmax":
            hparams["magnitude_max"] = float(val)
        elif key == "inc":
            if bool(val):
                transforms = _RAND_INCREASING_TRANSFORMS
        elif key == "m":
            magnitude = float(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
    ops = [AugmentOp(name, prob=0.5, magnitude=magnitude, hparams=hparams)
           for name in transforms]
    choice_weights = None
    if weight_idx is not None:
        w = np.asarray([_RAND_CHOICE_WEIGHTS_0[name] for name in transforms])
        choice_weights = w / w.sum()
    return RandAugment(ops, num_layers, choice_weights)


# ---------------------------------------------------------------------------
# AugMix
# ---------------------------------------------------------------------------

_AUGMIX_TRANSFORMS = [
    "AutoContrast", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing", "Equalize", "Rotate",
    "PosterizeIncreasing", "SolarizeIncreasing", "ShearX", "ShearY",
    "TranslateXRel", "TranslateYRel",
]


class AugMixAugment:
    """AugMix: ``width`` random op chains, mixed by Dirichlet weights and
    blended back into the source frame by a Beta draw."""

    def __init__(self, ops: Sequence[AugmentOp], alpha: float = 1.0,
                 width: int = 3, depth: int = -1, blended: bool = False):
        self.ops = list(ops)
        self.alpha = alpha
        self.width = width
        self.depth = depth
        self.blended = blended

    def _apply_basic(self, img, mixing_weights, m, rng):
        mixed = np.zeros(img.shape, dtype=np.float32)
        for mw in mixing_weights:
            depth = self.depth if self.depth > 0 else int(rng.integers(1, 4))
            picks = rng.choice(len(self.ops), depth, replace=True)
            img_aug = img
            for i in picks:
                img_aug = self.ops[i](img_aug, rng)
            mixed += mw * np.asarray(img_aug, dtype=np.float32)
        np.clip(mixed, 0, 255.0, out=mixed)
        return imaging.blend(img, mixed.astype(np.uint8), m)

    def __call__(self, img: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        mixing_weights = np.float32(rng.dirichlet([self.alpha] * self.width))
        m = np.float32(rng.beta(self.alpha, self.alpha))
        return self._apply_basic(img, mixing_weights, m, rng)


def augment_and_mix_transform(config_str: str, hparams: Optional[Dict] = None
                              ) -> AugMixAugment:
    """Parse e.g. ``'augmix-m5-w4-d2'``."""
    magnitude = 3
    width = 3
    depth = -1
    alpha = 1.0
    blended = False
    hparams = dict(hparams or {})
    config = config_str.split("-")
    if config[0] != "augmix":
        raise ValueError(f"an AugMix config starts with 'augmix', got "
                         f"{config_str!r}")
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            hparams["magnitude_std"] = float(val)
        elif key == "m":
            magnitude = float(val)
        elif key == "w":
            width = int(val)
        elif key == "d":
            depth = int(val)
        elif key == "a":
            alpha = float(val)
        elif key == "b":
            blended = bool(val)
    hparams.setdefault("magnitude_std", float("inf"))
    ops = [AugmentOp(name, prob=1.0, magnitude=magnitude, hparams=hparams)
           for name in _AUGMIX_TRANSFORMS]
    return AugMixAugment(ops, alpha=alpha, width=width, depth=depth,
                         blended=blended)
