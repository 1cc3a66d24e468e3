"""Wave mode (``Engine.prefill`` / ``Engine.generate`` / ``Scheduler.run``) and
the serve launcher of the port, against the JAX reference.

Both packages serve the smoke configs (llama2-7b with gear_kcvt4, and with
gear_kivi2 at head_dim 64, whose 64-wide V groups need it; hymba-1.5b;
rwkv6-3b) on the reference's parameters (``params_from_reference``).  The
waves hold uneven prompts, left-padded to the wave's longest, long enough
that a chunk closes in prefill and another during decode.  What is held:

* full-batch prefill logits within ``PREFILL_LOGIT_ATOL`` (0.1, as
  ``tests/test_torch_paged.py``);
* every greedy token the port serves, at every position of every row: both
  engines are teacher-forced at batch B along the port's own tokens; each
  token must be the port's argmax there (so ``Engine.generate``'s decode
  loop computes what its decode step does), and the packages' largest logit
  gap must stay within ``GAP_BEFORE_CLOSE`` until a chunk closes during
  decode and within ``GAP_AFTER_CLOSE`` after (the low-rank factors of a
  chunk closed on K/V one bf16 ulp apart differ, ROADMAP §3).  Against the
  reference's tokens: equal wherever the reference's top-1/top-2 margin
  exceeds twice that gap, and a row may leave the reference's stream only
  at a position where it does not;
* ``Scheduler.run`` against the port's own ``Engine.generate`` on the same
  padded waves, bit for bit, and its statuses against the reference's run;
* the launcher's printed lines and written JSON.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import Scheduler as RefScheduler  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, Request, Scheduler  # noqa: E402
from repro_torch.serving.scheduler import _pad  # noqa: E402

PREFILL_LOGIT_ATOL = 0.1
# Largest |port - reference| teacher-forced logit, before and after the first
# chunk that closes during decode (measured over this file: 0.172 and 0.285;
# with the decode step's RoPE one position off, 0.84-1.76).
GAP_BEFORE_CLOSE = 0.25
GAP_AFTER_CLOSE = 0.5
B = 4
GEN = 12
LENGTHS = [100, 123, 77, 110]          # padded to 123: decode closes chunk 1 at 128
CAP = max(LENGTHS) + GEN
CASES = {                              # id: (arch, policy, config overrides)
    "llama2-7b-gear_kcvt4": ("llama2-7b", "gear_kcvt4", {}),
    "llama2-7b-gear_kivi2-dh64": ("llama2-7b", "gear_kivi2", {"head_dim": 64}),
    "hymba-1.5b-gear_kcvt4": ("hymba-1.5b", "gear_kcvt4", {}),
    "rwkv6-3b": ("rwkv6-3b", "gear_kcvt4", {}),
}


class Case:
    """Both packages' engines of one case at batch B (dense, monolithic)."""

    def __init__(self, arch, polname, over):
        rcfg = dataclasses.replace(ref_smoke_config(arch), **over)
        ref_model = ref_build_model(rcfg)
        ref_params = ref_model.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(smoke_config(arch), **over)
        params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        self.cfg = cfg
        self.ref = RefEngine(ref_model, ref_params, RefEngineConfig(
            batch=B, capacity=CAP, policy=ref_named_policy(polname)))
        self.port = Engine(build_model(cfg), params, EngineConfig(
            batch=B, capacity=CAP, policy=named_policy(polname)), device="cpu")

    def prompts(self, lengths=LENGTHS, seed=0) -> list:
        rng = np.random.RandomState(seed)
        return [rng.randint(0, self.cfg.vocab_size, size=n).astype(np.int32) for n in lengths]

    def first_close(self, prompt_len: int) -> float:
        """Index of the first logits row computed after a chunk closed during
        decode (row t follows the token at position prompt_len + t - 1)."""
        if self.cfg.family == "ssm":                       # no KV cache: never
            return np.inf
        nb = self.port.ecfg.policy.buffer_size
        return nb - prompt_len % nb

    def teacher_forced(self, padded: np.ndarray, toks: np.ndarray):
        """(reference logits, port logits) [B, T, V] along ``toks`` [B, T]."""
        logits, caches = self.ref.prefill({"tokens": jnp.asarray(padded)})
        plogits, pcaches = self.port.prefill({"tokens": padded})
        ref, port = [], []
        S = padded.shape[1]
        for t in range(toks.shape[1]):
            ref.append(np.asarray(logits[:, -1].astype(jnp.float32)))
            port.append(plogits[:, -1].float().numpy())
            if t + 1 < toks.shape[1]:
                tok = np.ascontiguousarray(toks[:, t:t + 1])
                pos = np.full(B, S + t, np.int32)
                logits, caches = self.ref.decode({"tokens": jnp.asarray(tok)}, caches,
                                                 jnp.asarray(pos))
                plogits, pcaches = self.port.decode({"tokens": tok}, pcaches, pos)
        return np.stack(ref, 1), np.stack(port, 1)


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def case(request):
    return Case(*CASES[request.param])


def check_rows(case, padded, toks, ref_toks, widths) -> int:
    """The token rule of the module docstring over the port's rows ``toks``
    [B, T]; row b is compared with ``ref_toks[b, :widths[b]]``.  Returns the
    tokens equal to the reference's before each row's first difference."""
    ref, port = case.teacher_forced(padded, toks)
    gaps = np.abs(ref - port).max(-1)
    T = toks.shape[1]
    limit = np.where(np.arange(T) < case.first_close(padded.shape[1]),
                     GAP_BEFORE_CLOSE, GAP_AFTER_CLOSE)
    assert (gaps <= limit).all(), (gaps, limit)
    np.testing.assert_array_equal(toks, port.argmax(-1))
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sound = top2[..., 1] - top2[..., 0] > 2 * gaps
    shared = 0
    for b, width in enumerate(widths):
        diff = np.flatnonzero(toks[b, :width] != ref_toks[b, :width])
        n = diff[0] if diff.size else width
        assert n == width or not sound[b, n], f"row {b} leaves the reference at token {n}"
        shared += n
    return shared


def test_generate_matches_reference(case):
    padded = np.stack([_pad(p, max(LENGTHS)) for p in case.prompts()])
    ref_logits, _ = case.ref.prefill({"tokens": jnp.asarray(padded)})
    logits, caches = case.port.prefill({"tokens": padded})
    gap = np.abs(np.asarray(ref_logits.astype(jnp.float32)) - logits.float().numpy()).max()
    assert gap <= PREFILL_LOGIT_ATOL, gap
    ref_toks, ref_stats = case.ref.generate({"tokens": jnp.asarray(padded)}, GEN)
    toks, stats = case.port.generate({"tokens": padded}, GEN)
    ref_toks = np.asarray(ref_toks)
    assert toks.shape == ref_toks.shape == (B, GEN) and toks.dtype == np.int32
    assert stats["cache_bytes"] == ref_stats["cache_bytes"]
    assert stats["decode_tok_per_s"] > 0 and set(stats) == set(ref_stats)
    shared = check_rows(case, padded, toks, ref_toks, [GEN] * B)
    print(f"prefill logit gap {gap:.4f}; {shared} of {B * GEN} tokens as the reference's")


def test_scheduler_run_matches_reference(case):
    """Six requests of uneven prompts and budgets: two waves, the second
    filled with copies of its first request (left out of the results)."""
    lengths, budgets = [60, 90, 75, 40, 85, 50], [GEN, 5, GEN, 8, 3, GEN]
    prompts = case.prompts(lengths, seed=1)
    port = Scheduler(case.port)
    ref = RefScheduler(case.ref)
    for rid, (p, b) in enumerate(zip(prompts, budgets)):
        port.submit(Request(rid=rid, tokens=p, max_new_tokens=b))
        ref.submit(RefRequest(rid=rid, tokens=p, max_new_tokens=b))
    got = {r.rid: r for r in port.run()}
    want = {r.rid: r for r in ref.run()}
    assert sorted(got) == sorted(want) == list(range(6))
    assert port.last_stats["statuses"] == ref.last_stats["statuses"] == {"ok": 6}
    assert port.last_stats["tokens"] == ref.last_stats["tokens"] == sum(budgets)
    for rids in ([0, 1, 2, 3], [4, 5]):
        wave = [rids[i] if i < len(rids) else rids[0] for i in range(B)]
        pad = max(lengths[r] for r in wave)
        padded = np.stack([_pad(prompts[r], pad) for r in wave])
        budget = max(budgets[r] for r in wave)
        toks, _ = case.port.generate({"tokens": padded}, budget)
        ref_toks = np.zeros_like(toks)
        for i, r in enumerate(rids):
            np.testing.assert_array_equal(got[r].tokens, toks[i, :budgets[r]])
            ref_toks[i, :budgets[r]] = want[r].tokens
        check_rows(case, padded, toks, ref_toks, [budgets[r] for r in rids])


def test_prefill_raises_on_paged_engine():
    cfg = smoke_config("llama2-7b")
    eng = Engine(build_model(cfg), build_model(cfg).init(seed=0, device="cpu"),
                 EngineConfig(batch=2, capacity=128, policy=named_policy("gear_kcvt4"),
                              layout="paged"), device="cpu")
    with pytest.raises(NotImplementedError, match="dense-only"):
        eng.prefill({"tokens": np.zeros((2, 8), np.int32)})
    with pytest.raises(NotImplementedError, match="dense-only"):
        eng.generate({"tokens": np.zeros((2, 8), np.int32)}, 4)
    dense = Engine(eng.model, eng.params, dataclasses.replace(eng.ecfg, layout="dense"),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):        # a VLM batch
        dense.prefill({"tokens": np.zeros((2, 8), np.int32),
                       "img_embeds": np.zeros((2, 4, cfg.d_model), np.float32)})
    with pytest.raises(NotImplementedError, match="item 8"):        # audio codebooks
        dense.generate({"tokens": np.zeros((2, 8, 4), np.int32)}, 4)


# ---------------------------------------------------------------------------
# the launcher

GENERATED = re.compile(r"^generated \(4, 8\); prefill [0-9.]+s, decode [0-9.]+s "
                       r"\([0-9.]+ tok/s\), cache [0-9.]+ MB$")
SERVED = re.compile(r"^served 5 requests \(40 tokens\) in [0-9.]+s; attend=fused "
                    r"layout=paged; pool \d+/\d+ pages used, \d+ shared$")


def test_launcher_wave_mode(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "4", "--prompt", "40", "--gen", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and GENERATED.match(out[0]), out


def test_launcher_continuous_paged_obs(capsys, tmp_path):
    metrics, trace = tmp_path / "m" / "metrics.json", tmp_path / "trace.json"
    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt", "40", "--gen", "8",
                "--mode", "continuous", "--layout", "paged", "--requests", "5", "--obs",
                "--metrics-json", str(metrics), "--trace-out", str(trace)])
    out = capsys.readouterr().out.strip().splitlines()
    assert SERVED.match(out[0]), out
    assert out[1:] == ["obs: traces 5/5 rids complete=True",
                       f"obs: metrics snapshot -> {metrics}", f"obs: chrome trace -> {trace}"]
    snap = json.loads(metrics.read_text())
    assert snap["schema"] == "gear-repro/metrics/v1"
    values = {m["name"]: m["series"] for m in snap["metrics"]}
    assert values["serving_requests_submitted_total"][0]["value"] == 5
    assert values["serving_results_total"] == [{"labels": {"status": "ok"}, "value": 5.0}]
    doc = json.loads(trace.read_text())
    assert doc["schema"] == "gear-repro/trace/v1"
    assert {e["tid"] for e in doc["traceEvents"] if e["name"] == "request"} == set(range(5))


@pytest.mark.parametrize("flag,item", [(["--mesh", "2x2"], "item 10"),
                                       (["--fidelity-every", "2"], "item 7")])
def test_launcher_unported_flags_exit(flag, item):
    with pytest.raises(SystemExit, match=item):
        serve.main(["--smoke", "--device", "cpu", *flag])
