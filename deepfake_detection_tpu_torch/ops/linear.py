"""Dense layer with the JAX compute policy.

Counterpart of flax's ``nn.Dense(dtype=...)`` as the JAX models use it:
torch's ``nn.Linear`` (timm's ``weight``/``bias`` names, f32 parameters)
with ``compute_dtype`` (see :mod:`ops.conv`): None computes in the input's
dtype, a dtype casts the input and the parameters to it and outputs in it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import cast_compute

__all__ = ["Linear"]


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*cast_compute(self.compute_dtype, x, self.weight,
                                      self.bias))
