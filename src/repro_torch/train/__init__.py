"""Training state and loop of the port (one device)."""
