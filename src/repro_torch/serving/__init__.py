"""Serving: engine, slot views, continuous-batching scheduler."""
