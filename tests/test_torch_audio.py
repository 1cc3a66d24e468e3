"""musicgen-medium (ROADMAP queue 1, item 8.6) against the JAX reference: a
dense LayerNorm / GELU-MLP decoder over 4 EnCodec codebooks.  A frame's
tokens are 4 codebook ids (``[B, S, 4]``), embedded by 4 tables whose rows
sum, and the head gives 4 x vocab logits a position (``[B, 1, 4, V]``).  The
reference serves audio in wave mode only (``Engine.generate``): continuous
batching refuses it, and EOS never stops a frame.

Both packages run musicgen's smoke config (2 layers, d_model 64, 4 heads = 4
KV heads of 16, d_ff 128, vocab 512, 4 codebooks, an untied head) on the
reference's parameters (``params_from_reference``); the reference runs its
jitted programs with ``fused="interpret"`` (the Pallas kernels in interpret
mode), the port's CPU tensors the plain kernel versions.  Policy
gear_kcvt4, chunk 8, rank 2.

Tolerances, each measured on this file's inputs:

* the embedding bit for bit (the port keeps the reference's f32 tables, sums
  the 4 rows in codebook order in f32 and rounds once);
* the head's logits on the same hidden state within ``HEAD_ATOL`` (a bf16
  GEMM's sum order) and prefill logits within ``PREFILL_ATOL``;
* every generated frame under the teacher-forced rule of
  ``tests/test_torch_families.py``, per codebook: the port's argmax, every
  logit gap within ``GAP``, and at the first frame that leaves the
  reference's, each codebook id that differs only where the reference's
  top-2 margin is within twice the gap.
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

HEAD_ATOL = 2 ** -6      # measured 0.0039
PREFILL_ATOL = 0.0625    # measured 0.031
GAP = 0.1                # measured 0.055
K = 4                    # codebooks
B = 2
S = 19                   # 2 closed chunks and 3 buffered frames; a chunk closes in decode
CAP = 48
GEN = 10


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8), rank=2,
                               rank_decode=2)


class Pair:
    """Both packages' musicgen smoke model and batch-B engines on the
    reference's parameters."""

    def __init__(self):
        self.ref_cfg = ref_smoke_config("musicgen-medium")
        self.cfg = smoke_config("musicgen-medium")
        assert self.cfg.num_codebooks == K and not self.cfg.tie_embeddings
        self.ref_model = ref_build_model(self.ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.model = build_model(self.cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params), self.cfg,
                                            device="cpu")
        self.ref = R.Engine(self.ref_model, self.ref_params,
                            R.EngineConfig(batch=B, capacity=CAP, policy=small(jnamed)))
        self.port = P.Engine(self.model, self.params,
                             P.EngineConfig(batch=B, capacity=CAP, policy=small(named_policy)),
                             device="cpu")

    def frames(self, seed=0, n=S) -> np.ndarray:
        return np.random.RandomState(seed).randint(0, 512, size=(B, n, K)).astype(np.int32)


_PAIR: list = []


@pytest.fixture
def pair():
    if not _PAIR:
        _PAIR.append(Pair())
    return _PAIR[0]


def test_params_and_embedding_match_reference_bit_for_bit(pair):
    """The f32 tables [K, V, d] and the head [d, K * V] come across; the
    embedding of a frame batch [B, S, K] is the reference's bit for bit."""
    emb = pair.params.embed
    assert emb.dtype == torch.float32 and tuple(emb.shape) == (K, 512, 64)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(pair.ref_params["embed"]))
    assert tuple(pair.params.lm_head.shape) == (64, K * 512)
    toks = pair.frames(seed=1)
    want = to_np(ref_tfm.embed_tokens(pair.ref_cfg, pair.ref_params,
                                      {"tokens": jnp.asarray(toks)}))
    got = tfm.embed_tokens(pair.params, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, 64)
    np.testing.assert_array_equal(to_np(got), want)


def test_head_gives_per_codebook_logits(pair):
    """``logits_from_hidden`` reshapes ``h @ lm_head`` to [B, 1, K, V]: each
    codebook's logits within ``HEAD_ATOL`` of the reference's on the same
    hidden state, and the prefill's last-position logits within
    ``PREFILL_ATOL`` of the reference prefill's."""
    h = np.random.RandomState(2).randn(B, 1, 64).astype(np.float32)
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    want = to_np(ref_tfm.logits_from_hidden(pair.ref_cfg, pair.ref_params, hb))
    got = to_np(tfm.logits_from_hidden(pair.params,
                                       torch.from_numpy(to_np(hb)).to(torch.bfloat16)))
    assert got.shape == want.shape == (B, 1, K, 512)
    assert np.abs(got - want).max() <= HEAD_ATOL
    toks = pair.frames()
    ref_logits, _ = pair.ref.prefill({"tokens": jnp.asarray(toks)})
    logits, caches = pair.port.prefill({"tokens": toks})
    assert tuple(logits.shape) == (B, 1, K, 512)
    gap = np.abs(to_np(logits) - to_np(ref_logits)).max()
    print(f"musicgen prefill logit gap {gap:.4f}")
    assert gap <= PREFILL_ATOL
    assert all(to_np(c.length).tolist() == [S] * B for c in caches)


def teacher_forced(pair, toks, frames):
    """(reference, port) logits [B, T, K, V] along ``frames`` [B, T, K] at
    batch B: the wave's prefill, then decode steps fed [B, 1, K] at position
    S + t."""
    logits, caches = pair.ref.prefill({"tokens": jnp.asarray(toks)})
    plogits, pcaches = pair.port.prefill({"tokens": toks})
    ref, port = [], []
    for t in range(frames.shape[1]):
        ref.append(to_np(logits[:, -1]))
        port.append(to_np(plogits[:, -1]))
        if t + 1 < frames.shape[1]:
            tok = np.ascontiguousarray(frames[:, t:t + 1])
            pos = np.full(B, S + t, np.int32)
            logits, caches = pair.ref.decode({"tokens": jnp.asarray(tok)}, caches,
                                             jnp.asarray(pos))
            plogits, pcaches = pair.port.decode({"tokens": tok}, pcaches, pos)
    return np.stack(ref, 1), np.stack(port, 1)


def test_generate_frames_match_reference(pair):
    """``Engine.generate`` samples a frame [B, K] a step and feeds it back as
    [B, 1, K]: frames [B, GEN, K] in vocab, under the teacher-forced rule per
    codebook, with the reference's stats keys and cache bytes."""
    toks = pair.frames()
    ref_frames, ref_stats = pair.ref.generate({"tokens": jnp.asarray(toks)}, GEN)
    frames, stats = pair.port.generate({"tokens": toks}, GEN)
    ref_frames = np.asarray(ref_frames)
    assert frames.shape == ref_frames.shape == (B, GEN, K)
    assert frames.min() >= 0 and frames.max() < 512
    assert set(stats) == set(ref_stats) and stats["cache_bytes"] == ref_stats["cache_bytes"]
    rlog, plog = teacher_forced(pair, toks, frames)
    gaps = np.abs(rlog - plog).max(-1)                         # [B, T, K]
    print(f"largest gap {gaps.max():.4f}")
    assert (gaps <= GAP).all(), gaps
    np.testing.assert_array_equal(frames, plog.argmax(-1))
    for b in range(B):
        # the first frame that differs anywhere: past it the reference's own
        # stream fed back other ids; at it, only where rounding can explain it
        diff = np.flatnonzero((frames[b] != ref_frames[b]).any(-1))
        if diff.size:
            t = diff[0]
            for k in np.flatnonzero(frames[b, t] != ref_frames[b, t]):
                top2 = np.sort(rlog[b, t, k])[-2:]
                assert top2[1] - top2[0] <= 2 * gaps[b, t, k], (b, t, k)


def test_eos_is_ignored_and_frames_count_in_decode_rate(pair):
    """An ``eos_id`` that the frames contain stops nothing, in both packages:
    the same frames as without it; ``decode_tok_per_s`` counts frames (B x
    (GEN - 1) of them), as the reference's does."""
    toks = pair.frames(seed=3)
    plain, _ = pair.port.generate({"tokens": toks}, GEN)
    eos = int(plain[0, 1, 0])
    eng = P.Engine(pair.model, pair.params, dataclasses.replace(pair.port.ecfg, eos_id=eos),
                   device="cpu")
    ref_eng = R.Engine(pair.ref_model, pair.ref_params,
                       dataclasses.replace(pair.ref.ecfg, eos_id=eos))
    frames, _ = eng.generate({"tokens": toks}, GEN)
    np.testing.assert_array_equal(frames, plain)
    ref_frames, _ = ref_eng.generate({"tokens": jnp.asarray(toks)}, GEN)
    assert np.asarray(ref_frames).shape == (B, GEN, K)
    assert eng._decode_tok_per_s(frames, 2.0, None) == B * (GEN - 1) / 2.0
    assert ref_eng._decode_tok_per_s(frames, 2.0, None) == B * (GEN - 1) / 2.0
    active = np.array([True, False])
    assert eng._decode_tok_per_s(frames, 1.0, active) == (GEN - 1)


def test_batches_that_do_not_fit_the_model_raise(pair):
    """An audio engine takes [B, S, K] ids only; a text engine refuses
    codebook ids (``tests/test_torch_wave.py`` checks the latter on a llama
    engine)."""
    with pytest.raises(ValueError, match=r"codebook ids \[B, S, 4\]"):
        pair.port.prefill({"tokens": np.zeros((B, 8), np.int32)})
    with pytest.raises(ValueError, match=r"codebook ids \[B, S, 4\]"):
        pair.port.generate({"tokens": np.zeros((B, 8, 3), np.int32)}, 2)


def test_continuous_batching_refuses_audio_as_the_reference(pair):
    """``Scheduler.run_continuous`` raises ``NotImplementedError`` with the
    reference's message, in both packages."""
    msgs = []
    for mod, eng in ((R, pair.ref), (P, pair.port)):
        sched = mod.Scheduler(eng)
        with pytest.raises(NotImplementedError) as info:
            sched.run_continuous()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "continuous batching drives text tokens"


GENERATED = re.compile(r"^generated \(2, 4, 4\); prefill [0-9.]+s, decode [0-9.]+s "
                       r"\([0-9.]+ tok/s\), cache [0-9.]+ MB$")


def test_launcher_audio_branch(capsys):
    """Wave mode serves a seeded [batch, prompt, K] block of codebook ids and
    prints frames [batch, gen, K]; continuous mode (also implied by
    ``--layout paged``) exits, as the reference launcher does."""
    serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt", "24", "--gen", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and GENERATED.match(out[0]), out
    for extra in (["--mode", "continuous"], ["--layout", "paged"]):
        with pytest.raises(SystemExit, match="continuous mode drives text tokens"):
            serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu", *extra])
