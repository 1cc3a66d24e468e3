"""Host duration of one decode step (engine layer): the harness's range
around each ``Engine.decode`` call, median over every step of the traced
waves, in ms.  Each step starts by reading the caches' lengths back, so a
range holds the previous step's device tail and this step's launches."""

import statistics


def read(ctx):
    v = ctx.marks.durations("decode") + ctx.marks.durations("decode_close")
    return 1e3 * statistics.median(v) if v else None
