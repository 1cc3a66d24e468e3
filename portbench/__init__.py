"""The port's benchmark: wave generation on the H100 (see README.md)."""
