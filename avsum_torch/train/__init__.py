"""Training: steps, checkpoints and the trainer."""
