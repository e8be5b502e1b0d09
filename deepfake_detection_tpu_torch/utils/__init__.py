"""Utilities of the PyTorch port: metrics and the model EMA."""
