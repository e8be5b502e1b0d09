"""Training of the PyTorch port: state, steps, loops, checkpoints."""
