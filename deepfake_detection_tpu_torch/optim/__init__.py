"""Optimizers of the PyTorch port."""

from .factory import create_optimizer
from .rmsprop_tf import RMSpropTF
