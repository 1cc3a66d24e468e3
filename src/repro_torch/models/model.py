"""Public model facade: init / loss / prefill / decode / caches (port of
``repro.models.model.Model``).  A hybrid model's per-layer cache is the pair
(GEAR cache, SSM state), an RWKV6 model's its
:class:`~repro_torch.models.rwkv.RWKVState` (the compression policy touches
none of its layers); the facade passes them through.  The serving entry
points run under ``torch.inference_mode``; :meth:`Model.loss_fn` does not,
so autograd can differentiate it."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        tfm.check_supported(self.cfg)

    def init(self, seed: int = 0, device=None, dtype=tfm.COMPUTE_DTYPE) -> tfm.Transformer:
        """Random weights from a seeded generator (CUDA unless ``device``
        names another), the matrices in ``dtype`` (bf16 to serve, f32
        masters to train)."""
        return tfm.Transformer.random(self.cfg, seed, device, dtype)

    def loss_fn(self, params: tfm.Transformer, batch: dict, remat: bool = False,
                remat_policy: str = "full"):
        """Next-token cross-entropy plus the MoE load-balance loss.
        ``batch["tokens"]`` [B, S] ([B, S, K] for audio; a VLM's text, after
        ``batch["img_embeds"]`` [B, P, d]).  Returns (loss, {"ce", "aux"}),
        f32 scalars; labels are the next token of every position but the
        last (a VLM's text positions only; every codebook for audio)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        img = batch.get("img_embeds")
        img = None if img is None else torch.as_tensor(img, device=params.device)
        logits, aux = tfm.forward_train(params, tokens, img, remat=remat,
                                        remat_policy=remat_policy)
        labels = tokens[:, 1:]                       # [B, S-1] (audio: [B, S-1, K])
        if cfg.modality == "vlm":
            lg = logits[:, cfg.num_prefix_tokens:-1]     # the text positions
        else:
            lg = logits[:, :-1]
        ce = _xent(lg, labels)
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.inference_mode()
    def prefill(self, params: tfm.Transformer, batch: dict, policy: CompressionPolicy,
                capacity: int, prefill_mode: str = "monolithic", padded_tail: bool = False,
                true_len: int | None = None, heads=None):
        """Prefill of ``batch["tokens"]`` [B, S] on the weights' device, after
        ``batch["img_embeds"]`` [B, P, d] for a VLM when the batch has them,
        ``prefill_mode`` "monolithic" or "streaming" (same caches; see
        :func:`repro_torch.models.transformer.forward_prefill`, also for the
        bucketing hooks ``padded_tail`` / ``true_len``, and the mesh's head
        split ``heads``).  Returns (logits [B, 1, V], per-layer caches)."""
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        img = batch.get("img_embeds")
        img = None if img is None else torch.as_tensor(img, device=params.device)
        return tfm.forward_prefill(params, tokens, policy, capacity, prefill_mode,
                                   padded_tail, true_len, img_embeds=img, heads=heads)

    @torch.inference_mode()
    def prefill_suffix(self, params: tfm.Transformer, batch: dict, caches: list, start_pos: int,
                       policy: CompressionPolicy, capacity: int, padded_tail: bool = False,
                       true_len: int | None = None, heads=None):
        """Suffix prefill over a cache tree holding a chunk-aligned prefix.

        ``batch`` covers only the tokens after the cached prefix; ``caches``
        is a batch-1 tree whose first ``start_pos / n_b`` chunks were spliced
        from the prefix cache (:func:`repro_torch.core.cache.splice_prefix_chunks`).
        The streaming pipeline runs on the suffix with the prefix visible as
        compressed history, writing into ``caches`` in place: the engine's
        prefix-cache hit path.  The cache and last-position logits equal a
        cold streaming prefill of prefix + suffix bit for bit.
        ``padded_tail`` / ``true_len`` bucket the suffix as :meth:`prefill`
        does; ``true_len`` counts the suffix's real tokens.  Returns
        (logits [B, 1, V], caches)."""
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        return tfm.forward_prefill(params, tokens, policy, capacity, "streaming", padded_tail,
                                   true_len, start_pos=start_pos, init_caches=caches, heads=heads)

    @torch.inference_mode()
    def decode_step(self, params: tfm.Transformer, token_batch: dict, caches, pos,
                    policy: CompressionPolicy, capacity: int, lengths=None, block_tables=None,
                    fused: str = "auto", heads=None):
        """One decode step; ``pos`` is a scalar or a per-slot [B] vector of
        absolute positions; ``block_tables`` (a
        :class:`~repro_torch.core.cache.BlockTables`) is required for caches
        built with ``layout="paged"``; ``fused="off"`` sends every layer
        through the portable ``cache.attend``; ``heads`` the mesh's head
        split.  The caches advance in place; returns (logits [B, 1, V],
        caches)."""
        tokens = torch.as_tensor(token_batch["tokens"], device=params.device)
        logits = tfm.decode_tokens(params, tokens, caches, pos, policy, capacity, lengths,
                                   block_tables, fused, heads)
        return logits, caches

    def init_caches(self, policy: CompressionPolicy, batch: int, capacity: int, device=None,
                    layout: str = "dense", pool_pages: int = 0):
        return tfm.init_caches(self.cfg, policy, batch, capacity, resolve_device(device),
                               layout=layout, pool_pages=pool_pages)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of bf16 ``logits`` [..., V] at ``labels`` [...]
    without f32 logits: a row max that carries no gradient, the exp and sum
    in f32 (the reference's ``_xent``)."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    ex = torch.exp((logits - m).to(torch.float32))
    lse = torch.log(ex.sum(dim=-1)) + m[..., 0].to(torch.float32)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - ll.to(torch.float32))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
