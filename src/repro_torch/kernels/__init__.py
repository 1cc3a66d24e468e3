"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``quantize_chunk`` is exported here, as the reference's ``repro.kernels``
exports it.  It loads on first access: ``kernels.ops`` imports
``core.cache``, which imports this package.
"""

__all__ = ["quantize_chunk"]


def __getattr__(name: str):
    if name == "quantize_chunk":
        from repro_torch.kernels import ops
        return ops.quantize_chunk
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
