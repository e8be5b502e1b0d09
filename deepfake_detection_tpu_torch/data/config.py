"""Normalization constants by model name, and the trainer's input size.

Counterpart of the mean/std and input-size parts of
``deepfake_detection_tpu/data/config.py`` (its own copy of the rules and
constants): :func:`get_mean_by_model` / :func:`get_std_by_model` (a name
with ``dpn`` takes DPN's constants; one with ``ception``, or ``nasnet``
but not ``mnasnet``, Inception's 0.5; any other ImageNet's), and
:func:`resolve_mean_std`, the JAX ``resolve_data_config``'s rule for the
train runner, which always passes the model name: ``--mean``/``--std``
when given (a single value replicated to every input channel), else the
model name's constants.

:func:`resolve_input_size` is the runner's ``(C, H, W)`` from its flags:
``--input-size-v2``, then ``--input-size``, then ``--img-size`` (3
channels), as the JAX ``TrainConfig.resolved_input_size``; with none of
them the runner takes the registered model's ``default_cfg`` (CLI > model
config, as the original reference), where the JAX runner resolves (3,
224, 224) whatever the model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = ["IMAGENET_DEFAULT_MEAN", "IMAGENET_DEFAULT_STD",
           "IMAGENET_INCEPTION_MEAN", "IMAGENET_INCEPTION_STD",
           "IMAGENET_DPN_MEAN", "IMAGENET_DPN_STD", "get_mean_by_model",
           "get_std_by_model", "resolve_mean_std", "resolve_input_size"]

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)
IMAGENET_DPN_MEAN = (124 / 255, 117 / 255, 104 / 255)
IMAGENET_DPN_STD = tuple([1 / (.0167 * 255)] * 3)


def _family(model_name: str) -> str:
    name = model_name.lower()
    if "dpn" in name:
        return "dpn"
    if "ception" in name or ("nasnet" in name and "mnasnet" not in name):
        return "inception"
    return "imagenet"


def get_mean_by_model(model_name: str) -> Tuple[float, ...]:
    return {"dpn": IMAGENET_DPN_MEAN, "inception": IMAGENET_INCEPTION_MEAN,
            "imagenet": IMAGENET_DEFAULT_MEAN}[_family(model_name)]


def get_std_by_model(model_name: str) -> Tuple[float, ...]:
    return {"dpn": IMAGENET_DPN_STD, "inception": IMAGENET_INCEPTION_STD,
            "imagenet": IMAGENET_DEFAULT_STD}[_family(model_name)]


def resolve_mean_std(model_name: str, in_chans: int,
                     mean: Optional[Sequence[float]] = None,
                     std: Optional[Sequence[float]] = None
                     ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """``(mean, std)`` for ``model_name``: each given value list (one
    value → ``in_chans`` copies), else the name's constants."""
    def pick(given, default):
        if given is None:
            return tuple(default)
        given = tuple(float(v) for v in given)
        return given * in_chans if len(given) == 1 else given
    return (pick(mean, get_mean_by_model(model_name)),
            pick(std, get_std_by_model(model_name)))


def resolve_input_size(input_size_v2: Optional[Sequence[int]] = None,
                       input_size: Optional[Sequence[int]] = None,
                       img_size: Optional[int] = None
                       ) -> Optional[Tuple[int, int, int]]:
    """``(C, H, W)`` by the first flag given; None when none is."""
    for size in (input_size_v2, input_size):
        if size:
            if len(size) != 3:
                raise ValueError(f"an input size is C,H,W; got {size}")
            return tuple(int(v) for v in size)
    if img_size:
        return (3, int(img_size), int(img_size))
    return None
