"""Data of the PyTorch port: synthetic dataset, mixup, a minimal loader."""
