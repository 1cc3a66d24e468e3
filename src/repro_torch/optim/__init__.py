"""Optimizer and learning-rate schedules of the port's training path."""
