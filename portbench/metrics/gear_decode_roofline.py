"""``gear_decode``'s share of its roofline (kernels layer,
``kernels/gear_decode.py``): the least time of every decode step's launch
per layer (:func:`portbench.counts.kernels.gear_decode_least_s`, from the
step's compressed extent) over the device time of the kernels the profiler
names below, in %.  If the program renames the kernel, only this file goes
stale."""

from portbench.counts import kernels

KERNELS = ("gear_decode_split", "gear_history_mma")


def read(ctx):
    dev = sum(d for name, _, d in ctx.events if any(k in name for k in KERNELS)) / 1e9
    if dev <= 0:
        return None
    m, t = ctx.model, ctx.traffic
    nb = t["policy"]["chunk"]
    rows, g = m["num_kv_heads"], m["num_heads"] // m["num_kv_heads"]
    least = 0.0
    for w in ctx.waves:
        b, n_new = w["tokens"].shape[:2]
        for step in range(n_new - 1):
            n_comp = (t["prompt_len"] + step + 1) // nb * nb
            least += m["num_layers"] * kernels.gear_decode_least_s(
                t["policy"], b * rows, g, m["head_dim"], n_comp)
    return 100.0 * least / dev
