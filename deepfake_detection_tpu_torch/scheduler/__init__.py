"""LR schedules of the PyTorch port (numpy, copied from the JAX package)."""

from .factory import create_scheduler
