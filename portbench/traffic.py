"""Wave traffic: prompts from the seed, and the measured window.

A wave is one ``Engine.generate`` call: ``batch`` prompts of ``prompt_len``
token ids, each generating ``new_tokens`` greedy tokens (the batch-job
setting of the paper's throughput claim).  Wave ``w``'s prompts are drawn
from ``(seed, w)`` alone, uniform over the vocabulary, so every seed gives
the same sizes and the same seed the same inputs, however many waves a
window holds.

The window runs whole waves back to back.  A further wave starts only while
the time spent plus the last wave's duration stays within ``seconds`` (the
first always runs), so the window never holds a cut wave.
"""

from __future__ import annotations

import time

import numpy as np

KINDS = ("wave",)


def check(traffic: dict) -> None:
    if traffic.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {traffic.get('kind')!r}: this generator runs {KINDS}")
    nb = traffic["policy"]["chunk"]
    if traffic["capacity"] % nb or traffic["prompt_len"] + traffic["new_tokens"] - 1 > \
            traffic["capacity"]:
        raise ValueError("a wave's prompt and new tokens must fit the capacity, a chunk multiple")


def prompts(traffic: dict, vocab: int, seed: int, wave: int) -> np.ndarray:
    """Token ids [batch, prompt_len] (int32) of wave ``wave``."""
    rng = np.random.default_rng([int(seed), int(wave)])
    return rng.integers(0, vocab, size=(traffic["batch"], traffic["prompt_len"]),
                        dtype=np.int64).astype(np.int32)


def closing_steps(traffic: dict) -> list[int]:
    """Decode steps (0-based) in which every slot closes a chunk: step t
    appends position prompt_len + t."""
    nb, p = traffic["policy"]["chunk"], traffic["prompt_len"]
    return [t for t in range(traffic["new_tokens"] - 1)
            if (p + t + 1) % nb == 0 and p + t + 1 <= traffic["capacity"]]


def run_window(generate, traffic: dict, vocab: int, seed: int, seconds: float,
               clock=time.perf_counter) -> tuple[list, float]:
    """Whole waves of ``generate(tokens, new_tokens) -> (tokens, stats)``
    for about ``seconds``; returns (waves, window seconds), each wave a
    dict of its prompts, served tokens, stats and host start / end."""
    waves = []
    start = clock()
    last = 0.0
    while not waves or clock() - start + last <= seconds:
        batch = prompts(traffic, vocab, seed, len(waves))
        t0 = clock()
        toks, stats = generate(batch, traffic["new_tokens"])
        t1 = clock()
        last = t1 - t0
        waves.append({"prompts": batch, "tokens": np.asarray(toks), "stats": stats,
                      "t0": t0, "t1": t1})
    return waves, clock() - start
