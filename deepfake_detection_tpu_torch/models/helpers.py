"""Checkpoint loading for timm-named torch files, and the compute dtype.

Counterpart of ``load_state_dict`` / ``load_checkpoint`` in
``deepfake_detection_tpu/models/helpers.py``.  The port reads torch files
whose keys are timm's (the reference's released checkpoint format): a bare
state dict, or a dict holding ``state_dict`` and optionally
``state_dict_ema``, with DDP's ``module.`` prefix stripped.  Loading is
strict: a missing, unexpected or mis-shaped key raises.  JAX (flax msgpack)
checkpoints come across through :func:`convert.state_dict_from_flax`.

:func:`load_initial_checkpoint` is the JAX runner's ``--initial-checkpoint``
load: non-strict (a missing or mis-shaped key keeps its fresh value,
loudly), an error when nothing applies, and for a split-BN model
:func:`expand_split_bn` first.

:func:`set_compute_dtype` is the JAX ``build_model``'s ``dtype=``: the
modules that cast (``ops.conv.Conv2d``, a transformer's patch embedding
among them, ``ops.linear.Linear`` and ``ops.norm.LayerNorm``) compute in
it; parameters stay f32.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

_logger = logging.getLogger(__name__)

__all__ = ["load_state_dict", "load_checkpoint", "expand_split_bn",
           "load_initial_checkpoint", "set_compute_dtype"]


def load_state_dict(checkpoint_path: str,
                    use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """Read a checkpoint file onto the CPU; prefer the EMA stream when asked
    and present.  Only tensors and plain containers are unpickled."""
    if not checkpoint_path or not os.path.isfile(checkpoint_path):
        raise FileNotFoundError(f"No checkpoint at {checkpoint_path!r}")
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and use_ema and "state_dict_ema" in ckpt:
        _logger.info("Loaded state_dict_ema from %s", checkpoint_path)
        sd = ckpt["state_dict_ema"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_checkpoint(model: nn.Module, checkpoint_path: str,
                    use_ema: bool = False) -> nn.Module:
    """Strict load of a timm-named checkpoint into ``model`` (in place)."""
    sd = load_state_dict(checkpoint_path, use_ema)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    mismatched = sorted(k for k in set(own) & set(sd)
                        if tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or unexpected or mismatched:
        raise ValueError(
            f"{checkpoint_path}: {len(missing)} missing keys {missing[:5]}, "
            f"{len(unexpected)} unexpected keys {unexpected[:5]}, "
            f"{len(mismatched)} shape mismatches "
            f"{[(k, tuple(sd[k].shape), tuple(own[k].shape)) for k in mismatched[:5]]}")
    model.load_state_dict(sd, strict=True)
    return model


_AUX_BN = re.compile(r"^(.*)\.aux_bn\.\d+\.([^.]+)$")


def expand_split_bn(loaded: Dict[str, torch.Tensor],
                    model_keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """A plain-BN checkpoint adapted to a split-BN model, as the JAX
    ``expand_split_bn``: every ``<name>.aux_bn.<i>.<leaf>`` of the model
    that the checkpoint lacks takes the checkpoint's ``<name>.<leaf>``,
    which is a plain BN's tensor or, in a split-BN checkpoint with fewer
    splits, its main BN's (the port's main BN is ``<name>`` itself).
    Other keys pass through."""
    out = dict(loaded)
    for k in model_keys:
        m = _AUX_BN.match(k)
        if m is None or k in loaded:
            continue
        src = f"{m.group(1)}.{m.group(2)}"
        if src in loaded:
            out[k] = loaded[src]
    return out


def load_initial_checkpoint(model: nn.Module, checkpoint_path: str,
                            split_bn: bool = False
                            ) -> Tuple[int, int, int, int]:
    """``--initial-checkpoint``: the file's tensors into ``model`` where
    the key and shape match, fresh values elsewhere; with ``split_bn`` the
    checkpoint's BNs fan out to the aux BNs first.  Returns ``(applied,
    total, dropped, missing)``: keys loaded, keys of the model, keys whose
    shape differs (dropped with a warning) and keys absent from the file.
    Raises ``ValueError`` when nothing applies (a fine-tune from scratch
    by mistake is worse than failing)."""
    own = model.state_dict()
    loaded = load_state_dict(checkpoint_path)
    if split_bn:
        loaded = expand_split_bn(loaded, own)
    merged, dropped, hits = {}, 0, 0
    for k, v in own.items():
        lv = loaded.get(k)
        if lv is None:
            continue
        hits += 1
        if tuple(lv.shape) == tuple(v.shape):
            merged[k] = lv
        else:
            _logger.warning("shape mismatch at %s: checkpoint %s vs model "
                            "%s; dropped", k, tuple(lv.shape),
                            tuple(v.shape))
            dropped += 1
    applied = hits - dropped
    if applied == 0:
        raise ValueError(f"--initial-checkpoint {checkpoint_path} matches "
                         f"no parameter of the model; wrong architecture?")
    model.load_state_dict(merged, strict=False)
    _logger.info("Loaded initial checkpoint %s: %d/%d leaves applied (%d "
                 "shape-mismatched, %d missing keep their fresh init)",
                 checkpoint_path, applied, len(own), dropped,
                 len(own) - hits)
    return applied, len(own), dropped, len(own) - hits


def set_compute_dtype(model: nn.Module,
                      dtype: Optional[torch.dtype]) -> nn.Module:
    """Set ``compute_dtype`` on every module of ``model`` that has one
    (None: compute in the input's dtype, the f32 path)."""
    for m in model.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype
    return model
