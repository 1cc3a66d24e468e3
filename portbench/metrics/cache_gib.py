"""Bytes of a wave's whole cache tree (cache layer): ``Engine.generate``'s
``cache_bytes`` (``Engine.cache_nbytes``, the paper's KV-size count), the
largest over the traced waves, in GiB."""


def read(ctx):
    v = [w["stats"]["cache_bytes"] for w in ctx.waves]
    return max(v) / 2 ** 30 if v else None
