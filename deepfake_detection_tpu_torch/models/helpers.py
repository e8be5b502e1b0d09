"""Checkpoint loading for timm-named torch files, and the compute dtype.

Counterpart of ``load_state_dict`` / ``load_checkpoint`` in
``deepfake_detection_tpu/models/helpers.py``.  The port reads torch files
whose keys are timm's (the reference's released checkpoint format): a bare
state dict, or a dict holding ``state_dict`` and optionally
``state_dict_ema``, with DDP's ``module.`` prefix stripped.  Loading is
strict: a missing, unexpected or mis-shaped key raises.  JAX (flax msgpack)
checkpoints come across through :func:`convert.state_dict_from_flax`.

:func:`set_compute_dtype` is the JAX ``build_model``'s ``dtype=``: the
modules that cast (``ops.conv.Conv2d``, a transformer's patch embedding
among them, ``ops.linear.Linear`` and ``ops.norm.LayerNorm``) compute in
it; parameters stay f32.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

_logger = logging.getLogger(__name__)

__all__ = ["load_state_dict", "load_checkpoint", "set_compute_dtype"]


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


def set_compute_dtype(model: nn.Module,
                      dtype: Optional[torch.dtype]) -> nn.Module:
    """Set ``compute_dtype`` on every module of ``model`` that has one
    (None: compute in the input's dtype, the f32 path)."""
    for m in model.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype
    return model
