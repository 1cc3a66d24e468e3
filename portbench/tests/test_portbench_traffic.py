"""Traffic drawn from the seed, and the window's whole-wave rule."""

import numpy as np
import pytest

from portbench import spec, traffic

TRAFFIC = {w["traffic"]: spec.cell(w["name"])["traffic"] for w in spec.manifest()["workloads"]}
BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_same_seed_same_prompts(name):
    t = TRAFFIC[name]
    traffic.check(t)
    a = traffic.prompts(t, 49152, BIG_SEED, 0)
    b = traffic.prompts(t, 49152, BIG_SEED, 0)
    assert a.dtype == np.int32 and a.shape == (t["batch"], t["prompt_len"])
    assert np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < 49152
    assert not np.array_equal(a, traffic.prompts(t, 49152, BIG_SEED + 1, 0))
    assert not np.array_equal(a, traffic.prompts(t, 49152, BIG_SEED, 1))


def test_closing_steps():
    by_prompt = {t["prompt_len"]: traffic.closing_steps(t) for t in TRAFFIC.values()}
    assert by_prompt[1920] == [63]         # position 1983 closes chunk 30
    assert by_prompt[1984] == [] and by_prompt[4032] == []


def test_check_refuses_an_overlong_wave():
    t = dict(TRAFFIC["wave-b64-p1984-g16"], new_tokens=70)
    with pytest.raises(ValueError):
        traffic.check(t)
    with pytest.raises(ValueError):
        traffic.check(dict(t, kind="open-loop"))


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("wave_s, seconds, waves", [(3.0, 10.0, 3), (4.0, 10.0, 2),
                                                    (12.0, 10.0, 1), (5.0, 10.0, 2)])
def test_window_holds_whole_waves(wave_s, seconds, waves):
    clock = FakeClock()
    t = TRAFFIC["wave-b64-p1984-g16"]
    calls = []

    def generate(tokens, n):
        calls.append(tokens[0, :4].copy())
        clock.now += wave_s
        return np.zeros((tokens.shape[0], n), np.int32), {}

    got, window = traffic.run_window(generate, t, 1000, 7, seconds, clock=clock)
    assert len(got) == waves and window == pytest.approx(wave_s * waves)
    assert window <= max(seconds, wave_s)
    assert np.array_equal(calls[0], traffic.prompts(t, 1000, 7, 0)[0, :4])
