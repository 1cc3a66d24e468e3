"""GEAR core: KV-cache compression (quant backbone + low-rank + sparse).

The cache names load on first use (:func:`__getattr__`): ``core.cache``
imports the kernels, whose plain versions import ``core``'s leaf modules.
"""

import importlib

from repro_torch.core.policy import FP16, GEAR_DEFAULT, CompressionPolicy, named_policy
from repro_torch.core.gear import CompressedMatrix, approx_error, compress_matrix, decompress_matrix
from repro_torch.core.metrics import kv_size_breakdown, kv_size_fraction

__all__ = [
    "CompressionPolicy", "FP16", "GEAR_DEFAULT", "named_policy",
    "CompressedMatrix", "compress_matrix", "decompress_matrix", "approx_error",
    "CacheConfig", "GEARLayerCache", "FP16LayerCache", "WindowLayerCache",
    "init_layer_cache", "prefill_layer_cache", "streaming_prefill_layer_cache",
    "append_token", "attend", "dense_kv",
    "splice_slot", "reset_slot", "prefill_into_slot", "fresh_batch1_cache",
    "kv_size_breakdown", "kv_size_fraction",
]


def __getattr__(name: str):
    if name in __all__:            # the names bound above never get here
        return getattr(importlib.import_module("repro_torch.core.cache"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
