"""Training: optimizer, train step, checkpoints and metrics."""
