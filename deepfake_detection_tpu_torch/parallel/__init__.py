"""Parallel attention of the PyTorch port (counterpart of
``deepfake_detection_tpu/parallel``): for now only the dense reference."""
