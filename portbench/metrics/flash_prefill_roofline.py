"""``flash_prefill``'s share of its roofline (kernels layer,
``kernels/flash_prefill.py``): the least time of each wave's causal launch
per layer (:func:`portbench.counts.kernels.flash_prefill_least_s`) over the
device time of the kernels the profiler names below, in %.  If the program
renames the kernel, only this file goes stale."""

from portbench.counts import kernels

KERNELS = ("flash_prefill_kernel",)


def read(ctx):
    dev = sum(d for name, _, d in ctx.events if any(k in name for k in KERNELS)) / 1e9
    if dev <= 0:
        return None
    m = ctx.model
    rep = m["num_heads"] // m["num_kv_heads"]
    least = sum(m["num_layers"] * kernels.flash_prefill_least_s(
        ctx.traffic["prompt_len"], w["tokens"].shape[0] * m["num_heads"], rep, m["head_dim"])
        for w in ctx.waves)
    return 100.0 * least / dev
