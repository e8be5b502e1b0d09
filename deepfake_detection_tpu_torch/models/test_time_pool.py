"""Test-time pooling.

Counterpart of ``deepfake_detection_tpu/models/test_time_pool.py``: at
inference sizes larger than the train size, classify every ``pool×pool``
window and avg+max-pool the per-window logits instead of pooling features
once.  Rather than change the model, :func:`test_time_pool_apply` runs its
unpooled forward (``pool=False``) and applies the classifier as a 1×1
convolution.  A library function, as in the JAX package: no runner flag
reads it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pool import global_pool_nchw

_logger = logging.getLogger(__name__)

__all__ = ["test_time_pool_apply", "apply_test_time_pool"]


def test_time_pool_apply(model: nn.Module, x: torch.Tensor,
                         original_pool: int = 7,
                         classifier: str = "classifier") -> torch.Tensor:
    """Logits of ``model`` (in eval mode) on the NCHW batch ``x`` with
    test-time pooling: the feature map averaged over each
    ``original_pool``² window (stride 1, no padding), the ``classifier``
    linear layer (``default_cfg['classifier']``) as a 1×1 conv over it,
    then the ``avgmax`` global pool of the per-window logits."""
    feat = model(x, pool=False)
    p = original_pool
    feat = F.avg_pool2d(feat, p, stride=1)
    head = getattr(model, classifier)
    weight, bias = head.weight, head.bias
    if weight.dim() == 2:                      # linear → 1×1 conv
        weight = weight[:, :, None, None]
    logits = F.conv2d(feat, weight.to(feat.dtype))
    if bias is not None:
        logits = logits + bias.to(logits.dtype)[:, None, None]
    return global_pool_nchw(logits, "avgmax")


def apply_test_time_pool(model: nn.Module, config: Dict[str, Any],
                         no_test_pool: bool = False
                         ) -> Tuple[Optional[int], bool]:
    """Whether test-time pooling applies: ``config['input_size']`` larger
    than the model's default train size in both dims.  Returns
    ``(original_pool, enabled)`` for :func:`test_time_pool_apply`."""
    cfg = getattr(model, "default_cfg", None) or {}
    if no_test_pool or not cfg:
        return None, False
    want = config.get("input_size", ())
    have = cfg.get("input_size", ())
    if len(want) == 3 and len(have) == 3 and \
            want[-1] > have[-1] and want[-2] > have[-2]:
        pool = cfg.get("pool_size", (7, 7))
        pool = pool[0] if isinstance(pool, (tuple, list)) else pool
        _logger.info("Target input size %s > pretrained default %s, "
                     "using test time pooling", want[-2:], have[-2:])
        return pool, True
    return None, False
