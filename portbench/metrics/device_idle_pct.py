"""The H100's idle share of the traced window: the part of its wall time
covered by no kernel, copy or set (the union of the profiler's device
intervals), in %."""


def read(ctx):
    if ctx.reduced is None or ctx.reduced["window_s"] <= 0 or ctx.reduced["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.reduced["busy_s"] / ctx.reduced["window_s"])
