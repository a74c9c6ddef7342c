"""Training of the port: train step, optimizer, checkpoints, metrics."""
