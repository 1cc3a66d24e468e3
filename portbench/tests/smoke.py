"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
two layers of d_model 128 at the cells' head_dim 64, a 512-token
vocabulary, batch 2, prompts of 128 tokens and 66 new tokens, so that every
wave closes a chunk while it decodes (step 63 appends position 191)."""

import copy

from portbench import spec

# readings at this size on the CPU, seeds 1-12 (portbench/calibrate.py's numbers): the
# program's gap_max 0.026-0.142, gap_mean 0.0002-0.0054; the float8 control's gap_max
# 0.253-1.066, gap_mean 0.013-0.045; the faults of test_portbench_faults read 1 and more
SMOKE_LIMITS = {"gap_max": 0.2, "gap_mean": 0.009}


def smoke_cell(name: str = "minicpm-2b.batch-decode", mlp: str | None = None) -> dict:
    cell = copy.deepcopy(spec.cell(name))
    m = cell["config"]["model"]
    m.update(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=256,
             vocab_size=512)
    if mlp == "gelu_mlp":
        m.update(mlp_kind="gelu_mlp", norm="layernorm", norm_eps=1e-5, num_heads=8,
                 rope_theta=999999.4420358813)
    cell["traffic"].update(batch=2, prompt_len=128, new_tokens=66, capacity=256,
                           check={"requests": 2, "batch": 2})
    cell["limits"] = dict(SMOKE_LIMITS)
    return cell
