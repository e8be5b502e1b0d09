"""deepfake_detection_tpu_torch — the PyTorch/CUDA port for an NVIDIA H100.

A package beside ``deepfake_detection_tpu`` (the JAX reference), which it
never imports.  Tensors are NCHW-shaped in ``torch.channels_last`` memory,
modules carry timm's parameter names, and every TPU kernel on a ported path
is a hand-written Hopper kernel (``csrc/``) with a plain PyTorch version
beside it.  Entry points run on ``device="cuda"`` unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"

from . import registry
from .registry import list_models, model_entrypoint, register_model
