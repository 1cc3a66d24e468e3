"""Dense decoder: weights, prefill and cached decode."""
