"""Checkpoints of the port's training state."""
