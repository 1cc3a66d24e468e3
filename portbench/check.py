"""Whether what the timed path served is correct.

Once the window has closed, a sample of the requests it finished, drawn
from the seed, goes through the plain reference
(:func:`portbench.reference.model.logits`): each prompt followed by the
tokens the program served, teacher-forced.  The program served greedy
tokens, so each should be the reference's best at its position up to the
program's rounding; the number compared is the widest gap by which a
served token's reference logit lies below the reference's best
(``gap_max``), held to the cell's limit.  The control
(:func:`control_gaps`) reads, at the same positions, the gap of the token
that the reference computed in float8 puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref_model

CHECK_SALT = 0xC4EC


def sample(waves: list, n: int, seed: int) -> list[tuple[int, int]]:
    """``n`` (wave, row) pairs of the finished requests, drawn from the seed.
    Every request of a wave serves as many tokens (the longest are all)."""
    pairs = [(w, r) for w, wave in enumerate(waves) for r in range(wave["tokens"].shape[0])]
    rng = np.random.default_rng([int(seed), CHECK_SALT])
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    return [pairs[i] for i in sorted(pick)]


def _sequences(waves: list, pairs: list, device):
    """(tokens [b, P + T - 1], served [b, T]) of ``pairs`` on ``device``."""
    seq, served = [], []
    for w, r in pairs:
        p = waves[w]["prompts"][r]
        t = waves[w]["tokens"][r]
        seq.append(np.concatenate([p, t[:-1]]))
        served.append(t)
    return (torch.as_tensor(np.stack(seq), device=device),
            torch.as_tensor(np.stack(served).astype(np.int64), device=device))


def _gap(ref: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Reference best less the reference logit of ``tok``, per position."""
    return ref.amax(-1) - ref.gather(-1, tok[..., None])[..., 0]


def served_gaps(weights: dict, model: dict, traffic: dict, waves: list, pairs: list,
                device, batch: int, control: bool = False) -> dict:
    """Gaps of the served tokens of ``pairs`` against the reference (and,
    with ``control``, of the float8 reference's first choice), the share of
    served tokens equal to the reference's best, and the count compared."""
    prompt = traffic["prompt_len"]
    out = {"gap": [], "ctl_gap": [], "agree": 0, "tokens": 0}
    for i in range(0, len(pairs), batch):
        tokens, served = _sequences(waves, pairs[i:i + batch], device)
        ref = ref_model.logits(weights, model, traffic["policy"], tokens, prompt)
        out["gap"].append(_gap(ref, served).reshape(-1).cpu())
        out["agree"] += int((ref.argmax(-1) == served).sum())
        out["tokens"] += served.numel()
        if control:
            low = ref_model.logits(weights, model, traffic["policy"], tokens, prompt, "fp8")
            out["ctl_gap"].append(_gap(ref, low.argmax(-1)).reshape(-1).cpu())
            del low
        del ref
    for k in ("gap", "ctl_gap"):
        out[k] = torch.cat(out[k]) if out[k] else None
    return out


def numbers(gaps: torch.Tensor, new_tokens: int) -> dict:
    """The numbers a check can compare, of gaps [requests * new_tokens]: the
    widest and the mean gap of the served tokens, the share equal to the
    reference's best, and the widest gap of the prefill's token alone."""
    g = gaps.reshape(-1, new_tokens)
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "agree": float((g == 0).float().mean()), "gap_first_max": float(g[:, 0].max())}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number the cell's
    limits file holds a limit for (its ``readings`` are notes)."""
    shown, ok = {}, True
    for name, limit in limits.items():
        if name == "readings":
            continue
        value = values[name]
        shown[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, shown
