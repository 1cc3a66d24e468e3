"""A tensor on a device that has neither a kernel nor a plain version, for
the tests that check a kernel wrapper refuses such a device.

:func:`elsewhere` wraps a tensor's meta copy in a subclass that reports the
``xpu`` device (this build has no XPU backend, and the port no kernel for
one); every op on it runs on the meta tensor inside, so the code in front of
a wrapper runs as it would on a real device, computing nothing.  Give it
contiguous tensors: ``contiguous()`` of a strided one needs the device's
guard, which this build lacks.
"""

import torch
from torch.utils import _pytree as pytree


class Elsewhere(torch.Tensor):
    @staticmethod
    def __new__(cls, meta: torch.Tensor):
        return torch.Tensor._make_wrapper_subclass(cls, meta.shape, strides=meta.stride(),
                                                   dtype=meta.dtype, device="xpu")

    def __init__(self, meta: torch.Tensor):
        self.meta = meta

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        def unwrap(t):
            return t.meta if isinstance(t, Elsewhere) else t

        out = func(*pytree.tree_map(unwrap, args), **pytree.tree_map(unwrap, kwargs or {}))
        return pytree.tree_map(lambda t: Elsewhere(t) if isinstance(t, torch.Tensor) else t, out)


def elsewhere(x: torch.Tensor) -> Elsewhere:
    """``x``'s shape and dtype on the kernel-less device."""
    return Elsewhere(x.to("meta"))
