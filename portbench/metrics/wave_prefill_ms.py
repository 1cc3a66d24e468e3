"""Wall time of a wave's prefill (engine layer): ``Engine.generate``'s
``prefill_s`` (host clock from the call to the first token, ending in a
device sync), median over the traced waves, in ms."""

import statistics


def read(ctx):
    v = [w["stats"]["prefill_s"] for w in ctx.waves]
    return 1e3 * statistics.median(v) if v else None
