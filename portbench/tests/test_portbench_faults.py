"""A run whose timed path is broken underneath comes out not correct.

Each test drives :func:`portbench.run.run_cell` on the CPU at smoke size
(skipping only ``main``'s look for a card) with one fault of
:mod:`portbench.faults` planted in the program, and sees ``correct`` false;
the sound run beside them comes out true.  A served model can have two of
the contract's faults: a token altered where it is produced, and a step
that returns its state unchanged (a decode step whose cache never takes the
new token).  It has no batch mean and no exchange between chips.  A third
fault sits in the decode attention: the newest compressed chunk left out.
"""

import pytest
import torch

from portbench import faults, run
from portbench.tests.smoke import SMOKE_LIMITS, smoke_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _run(cell=None):
    return run.run_cell(cell or smoke_cell(), SEED, 0.0, False, CPU)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert all(v["value"] < v["limit"] for v in res["check"].values())
    assert res["compared_tokens"] == 2 * 66
    assert set(res["metrics"]) == {"peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "check"


def test_altered_token_is_caught():
    with faults.altered_token():
        res = _run()
    assert res["correct"] is False and res["check"]["gap_max"]["value"] > 1.0


def test_step_that_keeps_its_state_is_caught():
    with faults.state_unchanged():
        res = _run()
    assert res["correct"] is False and res["check"]["gap_max"]["value"] > 1.0


def test_dropped_history_chunk_is_caught():
    with faults.gear_decode_drops_a_chunk():
        res = _run()
    assert res["correct"] is False and res["check"]["gap_max"]["value"] > 1.0


def test_faults_are_undone():
    from repro_torch.kernels import ops

    before = ops.gear_decode
    with faults.gear_decode_drops_a_chunk():
        assert ops.gear_decode is not before
    assert ops.gear_decode is before


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limits(seed):
    """The float8 reference in the program's place reads over a limit that
    the program's own served tokens keep."""
    from portbench import calibrate

    got = calibrate.calibrate(smoke_cell(), seed, True, CPU)
    assert all(got["program"][k] <= v for k, v in SMOKE_LIMITS.items())
    assert any(got["control"][k] > v for k, v in SMOKE_LIMITS.items())
