"""Compressed-chunk store + cache-tree chunk extraction / splicing (port of
``repro.prefixcache.store``).

A chunk **payload** is everything needed to reproduce one ``n_b``-token
GEAR chunk in any slot of any same-geometry cache: a tuple over the model's
layers of per-layer field dicts (packed codes, quant stats, low-rank
factors, outliers; :func:`repro_torch.core.cache.extract_prefix_chunks`),
each a tensor with a leading batch-1 axis on the engine's device.  A hit is
spliced back with plain row writes and no recompression.

:class:`ChunkStore` owns the payloads behind integer handles (the radix
trie holds only handles and byte sizes) and counts their bytes exactly:
the number the trie's eviction budget governs.  The paged engine uses
:class:`repro_torch.serving.pagedpool.PagePoolStore` instead, whose
handles are pool page ids.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import cache as cache_lib

__all__ = ["ChunkStore", "chunk_keys", "payload_nbytes", "payload_finite",
           "extract_tree_chunks", "splice_tree_chunks"]


def chunk_keys(tokens, chunk: int) -> list[tuple[int, ...]]:
    """Trie edge labels for a prompt: its full ``chunk``-token chunks."""
    toks = [int(t) for t in tokens]
    n_full = len(toks) // chunk
    return [tuple(toks[c * chunk:(c + 1) * chunk]) for c in range(n_full)]


def _leaves(payload):
    if isinstance(payload, torch.Tensor):
        yield payload
    elif isinstance(payload, dict):
        for v in payload.values():
            yield from _leaves(v)
    elif isinstance(payload, (list, tuple)):
        for v in payload:
            yield from _leaves(v)
    elif hasattr(payload, "nbytes"):            # a numpy array (trie-level tests)
        yield payload


def payload_nbytes(payload) -> int:
    """Exact bytes of one chunk payload."""
    return sum(int(x.numel() * x.element_size()) if isinstance(x, torch.Tensor)
               else int(x.nbytes) for x in _leaves(payload))


def payload_finite(payload) -> bool:
    """Every floating tensor of the payload is finite (integer leaves cannot
    hold NaN/Inf)."""
    return all(bool(torch.isfinite(x).all()) for x in _leaves(payload)
               if isinstance(x, torch.Tensor) and x.is_floating_point())


class ChunkStore:
    """Handle-addressed payload store with exact byte accounting.

    The store protocol the :class:`repro_torch.prefixcache.PrefixCache`
    facade drives (``put`` / ``get`` / ``free`` and the ``nbytes_of``
    pricing hook) is also implemented by
    :class:`repro_torch.serving.pagedpool.PagePoolStore`.  ``validate=True``
    refuses a payload holding NaN/Inf with
    :class:`~repro_torch.core.cache.NumericFault`, so a poisoned chunk is
    never served to a later request.
    """

    def __init__(self, validate: bool = False):
        self.validate = bool(validate)
        self._entries: dict[int, tuple[Any, int]] = {}
        self._next_handle = 0
        self.total_bytes = 0
        self.validate_failures = 0

    @staticmethod
    def nbytes_of(payload) -> int:
        return payload_nbytes(payload)

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, payload) -> int:
        if self.validate and not payload_finite(payload):
            self.validate_failures += 1
            raise cache_lib.NumericFault("chunk payload holds NaN/Inf; refusing to cache it")
        handle = self._next_handle
        self._next_handle += 1
        nbytes = payload_nbytes(payload)
        self._entries[handle] = (payload, nbytes)
        self.total_bytes += nbytes
        return handle

    def get(self, handle: int):
        return self._entries[handle][0]

    def free(self, handle: int) -> None:
        _, nbytes = self._entries.pop(handle)
        self.total_bytes -= nbytes


# ---------------------------------------------------------------------------
# Engine cache tree <-> per-chunk payloads


def extract_tree_chunks(cfg: cache_lib.CacheConfig, caches: list, c_lo: int,
                        c_hi: int) -> list:
    """Copy chunks ``[c_lo, c_hi)`` out of a cache tree (a list of per-layer
    GEAR caches; a batch-1 prefill's in practice) into one payload per
    chunk: a tuple over layers of that chunk's field dicts.  The payloads
    own their memory (a view would keep the whole batch-1 cache alive)."""
    per_layer = [cache_lib.extract_prefix_chunks(cfg, layer, c_hi - c_lo, c_lo)
                 for layer in caches]
    return [tuple({f: t.clone() for f, t in chunks[c].items()} for chunks in per_layer)
            for c in range(c_hi - c_lo)]


def splice_tree_chunks(cfg: cache_lib.CacheConfig, caches: list, slot: int, payloads,
                       start_chunk: int = 0) -> list:
    """Write per-chunk payloads into batch row ``slot`` of every layer of a
    cache tree as chunks ``[start_chunk, start_chunk + len(payloads))``, in
    place (the prefix-cache half of the slot-splice protocol)."""
    for i, layer in enumerate(caches):
        cache_lib.splice_prefix_chunks(cfg, layer, slot, [p[i] for p in payloads],
                                       start_chunk)
    return caches
