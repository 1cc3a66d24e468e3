"""Seeded random weights, made on the device in a few large draws.

Each kind of matrix is one bf16 draw for all layers at once ([layers, d_in,
d_out]), normal with std ``d_in ** -0.5`` times the configuration's
``draw["std_factor"]`` for that matrix (1 where it names none); the
embedding (tied to the LM head) is one draw with std ``d_model ** -0.5``.
Norm scales and biases are float32 draws near their identity value, so
that the comparison sees them.
The program is handed views of these tensors as its parameters; the
reference reads the same tensors, so both start from one set of inputs.
"""

from __future__ import annotations

import torch

from portbench.counts.model import layer_weights

BF16 = torch.bfloat16
NORM_STD = 0.1


def matrix_shapes(model: dict) -> dict:
    """name -> (d_in, d_out) of every per-layer matrix."""
    d, dh, ff = model["d_model"], model["head_dim"], model["d_ff"]
    qd, kvd = model["num_heads"] * dh, model["num_kv_heads"] * dh
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
              "w_up": (d, ff), "w_down": (ff, d)}
    if model["mlp_kind"] in ("swiglu", "geglu"):
        shapes["w_gate"] = (d, ff)
    return shapes


def make(model: dict, seed: int, device, draw: dict | None = None) -> dict:
    """The weights of ``model`` drawn from ``seed`` on ``device``; ``draw``
    is the configuration file's ``draw`` (``{"std_factor": {"wq": 3.0}}``
    draws wq three times as wide, so that attention scores spread as a
    trained model's do and a query picks out a few keys)."""
    if not model.get("tie_embeddings", True):
        raise ValueError("the benchmark's weights tie the LM head to the embedding")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_layers, d = model["num_layers"], model["d_model"]
    if sum(a * b for a, b in matrix_shapes(model).values()) != layer_weights(model):
        raise ValueError("matrix shapes disagree with the FLOP count's weights")
    factor = (draw or {}).get("std_factor", {})
    if set(factor) - set(matrix_shapes(model)):
        raise ValueError(f"draw names no matrix of the model: {sorted(factor)}")
    w = {}
    for name, (d_in, d_out) in matrix_shapes(model).items():
        w[name] = torch.empty((n_layers, d_in, d_out), dtype=BF16, device=device).normal_(
            0.0, factor.get(name, 1.0) * d_in ** -0.5, generator=gen)
    w["embed"] = torch.empty((model["vocab_size"], d), dtype=BF16, device=device).normal_(
        0.0, d ** -0.5, generator=gen)
    rms = model["norm"] == "rmsnorm"
    for name, n in (("ln1", n_layers), ("ln2", n_layers), ("final_norm", None)):
        shape = (d,) if n is None else (n, d)
        scale = torch.empty(shape, dtype=torch.float32, device=device).normal_(
            0.0 if rms else 1.0, NORM_STD, generator=gen)
        w[name] = scale
        w[f"{name}_bias"] = (None if rms else torch.empty(
            shape, dtype=torch.float32, device=device).normal_(0.0, NORM_STD, generator=gen))
    return w


def to_program(weights: dict, cfg):
    """The program's ``Transformer`` whose parameters are views of
    ``weights`` (built on the meta device, so nothing else is allocated)."""
    from torch import nn

    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device="meta")

    def param(t):
        return None if t is None else nn.Parameter(t, requires_grad=False)

    model.embed = param(weights["embed"])
    model.final_norm = param(weights["final_norm"])
    model.final_norm_bias = param(weights["final_norm_bias"])
    for i, blk in enumerate(model.blocks):
        for name in list(matrix_shapes(_model_dict(cfg))) + ["ln1", "ln2"]:
            setattr(blk, name, param(weights[name][i]))
        for name in ("ln1_bias", "ln2_bias"):
            t = weights[name]
            setattr(blk, name, param(None if t is None else t[i]))
    for name, p in model.named_parameters():
        if p.device.type == "meta":
            raise ValueError(f"program parameter {name} was not given a weight")
    return model


def _model_dict(cfg) -> dict:
    return {"d_model": cfg.d_model, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "mlp_kind": cfg.mlp_kind}
