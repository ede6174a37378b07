"""Training: losses, the trainer and its logger."""
