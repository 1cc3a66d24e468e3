"""Frozen arithmetic: peaks, kernel bytes and operations, model FLOPs."""
