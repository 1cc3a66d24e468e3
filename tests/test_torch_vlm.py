"""paligemma-3b (ROADMAP queue 1, item 8.5) against the JAX reference: a
gemma decoder behind a prefix of image embeddings that attend each other
both ways (the prefix-LM mask of ``flash_prefill``'s ``prefix_len``), served
in wave mode (``tokens`` with ``img_embeds``) and in continuous batching
(text only, as the reference's ``Request`` carries no image).

Both packages run paligemma's smoke config (2 layers, d_model 64, 4 query
heads over one KV head of 16, GeGLU, vocab 512, 8 prefix tokens) on the
reference's parameters (``params_from_reference``); the reference runs its
jitted programs with ``fused="interpret"`` (the Pallas kernels in interpret
mode), the port's CPU tensors the plain kernel versions.  Policy
gear_kcvt4 with chunk 8 and rank 2.

Tolerances, each measured on this file's inputs:

* the embedding: image rows equal, text rows (scaled by sqrt(d_model))
  within ``EMBED_ULPS`` bf16 ulp (ROADMAP section 3, standing difference i);
* prefill logits within ``PREFILL_ATOL``, every cache's length the image
  prefix plus the text;
* every served token under the teacher-forced rule of
  ``tests/test_torch_families.py`` with the bound ``GAP``, in wave mode
  (teacher-forced at batch B, image rows included) and in continuous
  batching (teacher-forced at batch 1 on the text, decode positions after
  the prefix the request does not carry);
* streaming prefill equal to monolithic bit for bit (no VLM layer streams).
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as R  # noqa: E402
import repro_torch.serving as P  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

EMBED_ULPS = 1
PREFILL_ATOL = 0.0625    # measured 0.0313
GAP = 0.1                # measured 0.0391
PREFIX = 8               # smoke_config's num_prefix_tokens
B = 2
CAP = 64
GEN = 10
LENGTHS = [19, 27]       # prefix + text: 27 and 35 cache tokens, chunk closes in decode


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8), rank=2,
                               rank_decode=2)


class Pair:
    """Both packages' paligemma smoke model and batch-B engines on the
    reference's parameters, and the reference's jitted batch-1 programs."""

    def __init__(self):
        ref_cfg = ref_smoke_config("paligemma-3b")
        self.cfg = smoke_config("paligemma-3b")
        assert self.cfg.num_prefix_tokens == ref_cfg.num_prefix_tokens == PREFIX
        self.ref_cfg = ref_cfg
        self.ref_model = ref_build_model(ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.model = build_model(self.cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params), self.cfg,
                                            device="cpu")
        self.ref = R.Engine(self.ref_model, self.ref_params,
                            R.EngineConfig(batch=B, capacity=CAP, policy=small(jnamed)))
        self.port = P.Engine(self.model, self.params,
                             P.EngineConfig(batch=B, capacity=CAP, policy=small(named_policy)),
                             device="cpu")
        m, pol = self.ref_model, small(jnamed)
        self.ref_prefill1 = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP,
                                                           fused="interpret"))
        self.ref_decode1 = jax.jit(lambda p, t, c, pos: m.decode_step(
            p, {"tokens": t}, c, pos, pol, CAP, fused="interpret"))

    def batch(self, seed=0, S=LENGTHS[0]):
        """Text tokens [B, S] and seeded bf16 image embeddings [B, 8, d] for
        both packages (the same values)."""
        rng = np.random.RandomState(seed)
        toks = rng.randint(4, 512, size=(B, S)).astype(np.int32)
        img = torch.from_numpy(rng.standard_normal((B, PREFIX, self.cfg.d_model))
                               .astype(np.float32)).to(torch.bfloat16)
        return ({"tokens": jnp.asarray(toks), "img_embeds": jnp.asarray(to_np(img),
                                                                        jnp.bfloat16)},
                {"tokens": toks, "img_embeds": img})


_PAIR: list = []


@pytest.fixture
def pair():
    if not _PAIR:
        _PAIR.append(Pair())
    return _PAIR[0]


def test_embed_tokens_puts_image_rows_before_the_scaled_text(pair):
    jb, pb = pair.batch(seed=1)
    want = to_np(ref_tfm.embed_tokens(pair.ref_cfg, pair.ref_params, jb))
    got = to_np(tfm.embed_tokens(pair.params, torch.from_numpy(pb["tokens"]), pb["img_embeds"]))
    assert got.shape == want.shape == (B, PREFIX + LENGTHS[0], pair.cfg.d_model)
    np.testing.assert_array_equal(got[:, :PREFIX], to_np(pb["img_embeds"]))
    np.testing.assert_array_equal(got[:, :PREFIX], want[:, :PREFIX])
    assert (np.abs(got - want) / bf16_ulp(want)).max() <= EMBED_ULPS
    # a text model ignores img_embeds, as the reference's embed_tokens does
    gemma = tfm.Transformer(dataclasses.replace(pair.cfg, family="dense", modality="text",
                                                num_prefix_tokens=0), device="cpu")
    toks = torch.from_numpy(pb["tokens"])
    assert torch.equal(tfm.embed_tokens(gemma, toks, pb["img_embeds"]),
                       tfm.embed_tokens(gemma, toks))


def test_wave_prefill_matches_reference(pair, monkeypatch):
    """The full-batch prefill of text behind image embeddings: every
    attention call takes the 8-position bidirectional prefix, logits match,
    and every layer cache holds prefix + text."""
    prefixes = []
    real = ops.flash_attention

    def spy(*args, **kwargs):
        prefixes.append((kwargs.get("prefix_len", 0), kwargs.get("window", 0)))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "flash_attention", spy)
    jb, pb = pair.batch()
    ref_logits, ref_caches = pair.ref.prefill(jb)
    logits, caches = pair.port.prefill(pb)
    assert prefixes == [(PREFIX, 0)] * pair.cfg.num_layers
    gap = np.abs(to_np(logits) - to_np(ref_logits)).max()
    print(f"paligemma wave prefill logit gap {gap:.4f}")
    assert gap <= PREFILL_ATOL
    for c in caches:
        np.testing.assert_array_equal(to_np(c.length), [PREFIX + LENGTHS[0]] * B)
    # the image rows matter: other embeddings give other logits
    other = dict(pb, img_embeds=pb["img_embeds"] * 2)
    assert not torch.equal(pair.port.prefill(other)[0], logits)


def teacher_forced_wave(pair, jb, pb, toks):
    """(reference, port) logits [B, T, V] along ``toks`` [B, T] at batch B:
    prefill with the image rows, then decode at positions prefix + S + t."""
    logits, caches = pair.ref.prefill(jb)
    plogits, pcaches = pair.port.prefill(pb)
    start = pair.port._prompt_len(pb)
    assert start == PREFIX + pb["tokens"].shape[1]
    ref, port = [], []
    for t in range(toks.shape[1]):
        ref.append(np.asarray(logits[:, -1].astype(jnp.float32)))
        port.append(plogits[:, -1].float().numpy())
        if t + 1 < toks.shape[1]:
            tok = np.ascontiguousarray(toks[:, t:t + 1])
            pos = np.full(B, start + t, np.int32)
            logits, caches = pair.ref.decode({"tokens": jnp.asarray(tok)}, caches,
                                             jnp.asarray(pos))
            plogits, pcaches = pair.port.decode({"tokens": tok}, pcaches, pos)
    return np.stack(ref, 1), np.stack(port, 1)


def check_tokens(toks, ref_toks, rlog, plog):
    """The teacher-forced rule over rows of ``toks`` [N, T]."""
    gaps = np.abs(rlog - plog).max(-1)
    print(f"largest gap {gaps.max():.4f}")
    assert (gaps <= GAP).all(), gaps
    np.testing.assert_array_equal(toks, plog.argmax(-1))
    for b in range(toks.shape[0]):
        diff = np.flatnonzero(toks[b] != ref_toks[b])
        if diff.size:
            top2 = np.sort(rlog[b, diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[b, diff[0]], (b, toks[b], ref_toks[b])


def test_generate_matches_reference(pair):
    """``Engine.generate`` on a VLM batch: tokens [B, GEN] under the
    teacher-forced rule, the same stats keys and cache bytes."""
    jb, pb = pair.batch(seed=2)
    ref_toks, ref_stats = pair.ref.generate(jb, GEN)
    toks, stats = pair.port.generate(pb, GEN)
    assert toks.shape == (B, GEN) and set(stats) == set(ref_stats)
    assert stats["cache_bytes"] == ref_stats["cache_bytes"]
    rlog, plog = teacher_forced_wave(pair, jb, pb, toks)
    check_tokens(toks, np.asarray(ref_toks), rlog, plog)


def along_text(pair, prompt, toks, offset=PREFIX):
    """(reference, port) logits [T, V] along ``toks`` at batch 1: the text
    prompt prefilled alone, decode from position ``len(prompt) + offset``."""
    pol = small(named_policy)
    logits, caches = pair.ref_prefill1(pair.ref_params, jnp.asarray(prompt[None]))
    plogits, pcaches = pair.model.prefill(pair.params, {"tokens": prompt[None]}, pol, CAP)
    ref, port = [], []
    for i, tok in enumerate(toks):
        ref.append(np.asarray(logits[0, -1].astype(jnp.float32)))
        port.append(plogits[0, -1].float().numpy())
        if i + 1 < len(toks):
            pos = len(prompt) + offset + i
            logits, caches = pair.ref_decode1(pair.ref_params, jnp.asarray([[tok]], jnp.int32),
                                              caches, jnp.asarray([pos], jnp.int32))
            plogits, pcaches = pair.model.decode_step(
                pair.params, {"tokens": np.array([[tok]])}, pcaches, np.array([pos]), pol, CAP)
    return np.stack(ref), np.stack(port)


def requests(mod):
    rng = np.random.RandomState(3)
    return [mod.Request(rid=i, tokens=rng.randint(4, 512, size=n), max_new_tokens=b)
            for i, (n, b) in enumerate(zip([19, 27, 19], [GEN, 6, 8]))]


def test_run_continuous_matches_reference_and_decodes_after_the_prefix(pair):
    """Continuous batching of text-only requests (the reference's ``Request``
    carries no image): each prompt prefills alone, its first 8 text rows
    bidirectional, and decodes from ``len(tokens) + 8``, the reference's
    rule (the first step's positions equal the reference engine's).  Every
    token under the teacher-forced rule along those positions;
    the same tokens teacher-forced from ``len(tokens)`` leave the
    reference's logits by more than ``GAP``, so the rule is what holds the
    run."""
    got, first_pos = {}, {}
    for name, mod, eng in (("ref", R, pair.ref), ("port", P, pair.port)):
        seen = []

        def spy(token_batch, caches, pos, real=eng.decode, seen=seen):
            seen.append(np.asarray(pos).copy())
            return real(token_batch, caches, pos)

        sched = mod.Scheduler(eng)
        for r in requests(mod):
            sched.submit(r)
        eng.decode = spy
        try:
            got[name] = {r.rid: r for r in sched.run_continuous()}
        finally:
            del eng.decode
        assert sched.last_stats["statuses"] == {"ok": 3}
        first_pos[name] = seen[0].tolist()
    # requests 0 and 1 take slots 0 and 1: their first step decodes after the prefix
    assert first_pos["port"] == first_pos["ref"] == [19 + PREFIX, 27 + PREFIX]
    for r in requests(P):
        toks = np.asarray(got["port"][r.rid].tokens)
        rlog, plog = along_text(pair, r.tokens.astype(np.int32), toks)
        check_tokens(toks[None], np.asarray(got["ref"][r.rid].tokens)[None], rlog[None],
                     plog[None])
        _, shifted = along_text(pair, r.tokens.astype(np.int32), toks, offset=0)
        print(f"rid {r.rid}: decoding from len(tokens) instead: gap {np.abs(shifted - rlog).max():.3f}")
        assert np.abs(shifted - rlog).max() > GAP


def test_need_tokens_counts_the_prefix(pair):
    """A request's lifetime holds the image prefix: one whose text and budget
    fit the capacity only without it is refused at submit, by both packages."""
    n = CAP - PREFIX                       # n + GEN - 1 fits CAP, n + 8 + GEN - 1 does not
    for mod, eng in ((R, pair.ref), (P, pair.port)):
        sched = mod.Scheduler(eng)
        req = mod.Request(rid=0, tokens=np.zeros(n, np.int32), max_new_tokens=GEN)
        assert sched._need_tokens(req) == n + PREFIX + GEN - 1
        with pytest.raises(ValueError):
            sched.submit(req)


def test_streaming_prefill_is_monolithic_and_prefix_cache_is_off(pair):
    """No VLM layer streams (the history scorer has no bidirectional prefix),
    so a streaming prefill equals the monolithic one bit for bit; the prefix
    cache refuses the model with the reference's reason."""
    pol = small(named_policy)
    prompt = np.random.RandomState(4).randint(4, 512, size=(1, 27)).astype(np.int32)
    mono = pair.model.prefill(pair.params, {"tokens": prompt}, pol, CAP)
    stream = pair.model.prefill(pair.params, {"tokens": prompt}, pol, CAP,
                                prefill_mode="streaming")
    assert torch.equal(mono[0], stream[0])
    for a, b in zip(mono[1], stream[1], strict=True):
        for name, t in a.tensors().items():
            assert torch.equal(t, getattr(b, name)), name
    reason = P.prefix_cache_unsupported_reason(pair.cfg, pol, CAP)
    assert reason == R.prefix_cache_unsupported_reason(pair.ref_cfg, small(jnamed), CAP)
    assert reason.startswith("modality 'vlm'")


GENERATED = re.compile(r"^generated \(2, 4\); prefill [0-9.]+s, decode [0-9.]+s "
                       r"\([0-9.]+ tok/s\), cache [0-9.]+ MB$")


def test_launcher_vlm_branch(capsys):
    """Wave mode serves a seeded ``img_embeds`` batch at a capacity that holds
    the prefix; continuous mode exits, as the reference launcher does."""
    serve.main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt", "24", "--gen", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and GENERATED.match(out[0]), out
    with pytest.raises(SystemExit, match="continuous mode drives text tokens"):
        serve.main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu", "--mode",
                    "continuous"])
