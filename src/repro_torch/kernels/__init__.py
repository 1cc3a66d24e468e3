"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``gear_attend``, ``flash_attention`` and ``quantize_chunk`` are exported
here, as the reference's ``repro.kernels`` exports them.  They load on first
access: ``kernels.ops`` imports ``core.cache``, which imports this package.
"""

__all__ = ["gear_attend", "flash_attention", "quantize_chunk"]


def __getattr__(name: str):
    if name in __all__:
        from repro_torch.kernels import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
