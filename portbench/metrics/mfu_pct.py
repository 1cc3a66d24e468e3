"""The model step's share of the card's dense bf16 peak: the model FLOPs of
every wave in the traced window (:func:`portbench.counts.model.wave_flops`)
over the window's wall time times 989 TFLOP/s, in %."""

from portbench.counts import model as model_counts
from portbench.counts import peaks


def read(ctx):
    if not ctx.waves or ctx.window_s <= 0:
        return None
    t = ctx.traffic
    flops = sum(model_counts.wave_flops(ctx.model, w["tokens"].shape[0], t["prompt_len"],
                                        w["tokens"].shape[1]) for w in ctx.waves)
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
