"""Model FLOPs of wave generation, counted from the configuration.

Serving needs 2 operations per weight and token (a multiply and an add),
over the non-embedding weights for every token a layer processes, plus the
tied LM head (2 x d x vocab) for every position whose logits are computed
(a prefill's last position, every decode step), plus causal attention (4 x
head_dim operations per query head and kept (query, key) pair: QK and PV).
``repro_torch.perf.roofline.model_flops`` counts 6 N D for training and
is not used here.
"""

from __future__ import annotations

from portbench.counts.kernels import causal_pairs


def layer_weights(model: dict) -> int:
    """Weights of one decoder layer's matrices (attention and MLP)."""
    d, dh = model["d_model"], model["head_dim"]
    qd, kvd = model["num_heads"] * dh, model["num_kv_heads"] * dh
    mats = 3 if model["mlp_kind"] in ("swiglu", "geglu") else 2
    return 2 * d * qd + 2 * d * kvd + mats * d * model["d_ff"]


def head_flops(model: dict) -> float:
    """Operations of the LM head for one position."""
    return 2.0 * model["d_model"] * model["vocab_size"]


def wave_flops(model: dict, batch: int, prompt: int, new_tokens: int) -> float:
    """Operations of one wave: a prefill of ``batch`` prompts of ``prompt``
    tokens (logits of the last position only), then ``new_tokens - 1``
    decode steps, step ``t`` attending ``prompt + t + 1`` keys."""
    n_layers, dh, hq = model["num_layers"], model["head_dim"], model["num_heads"]
    per_token = 2.0 * layer_weights(model) * n_layers
    attn = 4.0 * dh * hq * n_layers
    total = batch * (prompt * per_token + head_flops(model) + attn * causal_pairs(prompt))
    for t in range(new_tokens - 1):
        total += batch * (per_token + head_flops(model) + attn * (prompt + t + 1))
    return total
