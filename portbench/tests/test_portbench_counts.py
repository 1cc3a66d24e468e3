"""The frozen FLOP, byte and roofline arithmetic against hand-worked values."""

import json

import pytest

from portbench import spec
from portbench.counts import kernels, model, peaks

MINICPM = spec.cell("minicpm-2b.batch-decode")["config"]["model"]
STARCODER = spec.cell("starcoder2-3b.batch-prefill")["config"]["model"]
POLICY = spec.cell("minicpm-2b.batch-decode")["traffic"]["policy"]


def test_peaks_are_the_data_sheet():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.F32_FLOPS == 67e12


def test_gear_chunk_bytes_by_hand():
    # head_dim 64, 4-bit, rank 4, one outlier each way on K (64 tokens) and V (64 channels):
    # a token: K and V codes 32 + 32, V scale and min 2 + 2, A rows 8 + 8, V outliers 2 x 6
    # a chunk: K scale and min 128 + 128, B factors 512 + 512, K outliers 64 x 2 x 6
    assert kernels.gear_chunk_bytes(POLICY, 64) == 64 * (32 + 32 + 4 + 16 + 12) + (256 + 1024 + 768)
    # head_dim 128: two V outliers each way (ceil(128 * 0.02 / 2) = 2)
    assert kernels.gear_chunk_bytes(POLICY, 128) == (64 * (64 + 64 + 4 + 16 + 24)
                                                     + (512 + 2048 + 1536))
    assert kernels.gear_chunk_bytes(POLICY, 64) == 8192


def test_gear_decode_bound_at_both_configs():
    # minicpm-2b, cell 1's first step: 64 x 36 rows, 1 query row each, 1,920 compressed tokens
    nbytes, flops = kernels.gear_decode_bytes_flops(POLICY, 64 * 36, 1, 64, 1920)
    live = 64 * 36 * 30
    assert nbytes == live * 8192 + 2304 * 64 * 4 + 2304 * 4 + 2304 * 66 * 4
    assert flops == live * (4 * 64 * 64 + 4 * 64 * 64 + 4 * 64 * 4 + 4 * 64 * 4)
    least = kernels.gear_decode_least_s(POLICY, 64 * 36, 1, 64, 1920)
    assert least == pytest.approx(nbytes / 3.35e12)            # bytes bound
    # starcoder2-3b: 64 x 2 rows of 12 query heads, 4,032 compressed tokens: compute bound
    nbytes, flops = kernels.gear_decode_bytes_flops(POLICY, 128, 12, 128, 4032)
    live = 128 * 63
    assert flops == live * (4 * 64 * 128 + 12 * (4 * 64 * 128 + 4 * 128 * 4 + 4 * 64 * 4))
    assert kernels.gear_decode_least_s(POLICY, 128, 12, 128, 4032) == pytest.approx(
        flops / 67e12)
    assert kernels.gear_decode_least_s(POLICY, 128, 12, 128, 4000) == pytest.approx(
        kernels.gear_decode_least_s(POLICY, 128, 12, 128, 4032))   # a partial chunk is live


def test_flash_prefill_by_hand():
    nbytes, flops = kernels.flash_prefill_bytes_flops(1920, 64 * 36, 1, 64)
    assert nbytes == 2 * 64 * 1920 * (2 * 2304 + 2 * 2304)
    assert flops == 4 * (1920 * 1921 // 2) * 64 * 2304
    assert kernels.flash_prefill_least_s(1920, 2304, 1, 64) == pytest.approx(flops / 989e12)
    nbytes, _ = kernels.flash_prefill_bytes_flops(4032, 64 * 24, 12, 128)
    assert nbytes == 2 * 128 * 4032 * (2 * 1536 + 2 * 128)


def test_model_flops_by_hand():
    # minicpm-2b: per layer 4 x 2304^2 attention weights (36 heads of 64 = 2304) and 3 x 2304 x 5760
    assert model.layer_weights(MINICPM) == 4 * 2304 * 2304 + 3 * 2304 * 5760
    # starcoder2-3b: q and o 3072 x 3072, k and v 3072 x 256, GELU MLP 2 x 3072 x 12288
    assert model.layer_weights(STARCODER) == 2 * 3072 * 3072 + 2 * 3072 * 256 + 2 * 3072 * 12288
    f = model.wave_flops(MINICPM, 2, 10, 3)
    per_tok = 2 * model.layer_weights(MINICPM) * 40
    head = 2 * 2304 * 122753
    attn = 4 * 64 * 36 * 40
    assert f == pytest.approx(2 * (10 * per_tok + head + attn * 55)
                              + 2 * (per_tok + head + attn * 11)
                              + 2 * (per_tok + head + attn * 12))


def test_counts_agree_with_the_programs_parameter_count():
    from repro_torch.configs.base import ModelConfig
    import dataclasses

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    for m in (MINICPM, STARCODER):
        cfg = ModelConfig(**{k: v for k, v in m.items() if k in names})
        assert cfg.param_count() == (m["num_layers"] * model.layer_weights(m)
                                     + m["vocab_size"] * m["d_model"])


def test_configs_state_the_published_widths():
    for m, pub in ((MINICPM, "minicpm-2b"), (STARCODER, "starcoder2-3b")):
        body = json.loads((spec.ROOT / f"portbench/configs/{pub}.json").read_text())
        p = body["published"]
        assert m["d_model"] == p["hidden_size"] and m["d_ff"] == p["intermediate_size"]
        assert m["num_layers"] == p["num_hidden_layers"]
        assert m["num_heads"] == p["num_attention_heads"]
        assert m["num_kv_heads"] == p["num_key_value_heads"]
        assert m["vocab_size"] == p["vocab_size"]
        assert m["num_heads"] * m["head_dim"] == p["hidden_size"]
