"""The cell flow on the card at smoke size (marker ``cuda``: skips without one).

Run on the card with ``python -m pytest -m cuda portbench/tests``."""

import pytest
import torch

from portbench import run
from portbench.tests.smoke import smoke_cell


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_smoke_cell_on_the_card(trace):
    dev = _card()
    # head_dim 64 and 128 both have kernel builds; the smoke cell keeps 64
    res = run.run_cell(smoke_cell("minicpm-2b.batch-prefill"), 2 ** 31 + 9, 0.5, trace, dev)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
        assert "gear_decode_roofline" in res["metrics"]
        assert 0 < res["metrics"]["gear_decode_roofline"]["value"] <= 105
    else:
        assert res["metrics"]["gen_tok_per_s"]["value"] > 0
