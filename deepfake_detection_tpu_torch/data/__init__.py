"""Data of the PyTorch port: the clip dataset and its packed cache, the
samplers, the host transforms, the device augment chain, RandomErasing,
mixup and the loaders."""
