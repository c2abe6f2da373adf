"""Train/eval cores, the epoch driver and checkpoints."""
