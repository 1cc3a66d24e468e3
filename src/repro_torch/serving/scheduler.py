"""Slot-level continuous batching over one :class:`Engine` (port of
``repro.serving.scheduler``'s fault-free ``run_continuous`` path).

A step loop decodes all B slots each step with per-slot positions; the
moment a slot's request reaches its EOS or budget, the next queued request
is prefilled at batch 1 and spliced into that slot while the others keep
decoding.  On the paged layout a request is admitted only when the pool
holds the pages of its lifetime; until then it waits at the queue head.
When the engine has a prefix cache, the scheduler's admission policy
(``prefix_admission``) reaches every slot prefill, a paged engine whose
slots are all idle while the head still does not fit reclaims trie pages
(the reclaim valve), and ``last_stats`` reports the run's prefix counters.
Retries, deadlines, quarantine handling and fault injection arrive with
ROADMAP queue item 5, telemetry with item 6.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque

import numpy as np
import torch

from repro_torch.serving.engine import Engine
from repro_torch.serving.pagedpool import PoolExhausted, pages_needed
from repro_torch.serving.resilience import RequestStatus
from repro_torch.serving.sampling import sample

__all__ = ["Request", "Result", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # [prompt_len] int32
    max_new_tokens: int = 64


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray            # generated ids, truncated at first EOS
    prefill_s: float
    decode_s: float
    status: RequestStatus = RequestStatus.OK


class Scheduler:
    """Request queue + continuous batching over one engine; per-run
    aggregates land in :attr:`last_stats`.  ``prefix_admission`` is "all"
    (every request's newly closed prompt chunks enter the trie) or "off"
    (cached prefixes are reused, nothing new is admitted)."""

    def __init__(self, engine: Engine, seed: int = 0, prefix_admission: str = "all"):
        if prefix_admission not in ("all", "off"):
            raise ValueError(f"prefix_admission must be all/off, got {prefix_admission!r}")
        self.engine = engine
        self.prefix_admission = prefix_admission
        self.queue: deque[Request] = deque()
        self.last_stats: dict = {}
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)

    def _need_tokens(self, req: Request) -> int:
        """Cache tokens the request's lifetime holds: prompt + one appended
        token per decode step (the first token comes from prefill).  A paged
        admission reserves exactly these pages."""
        return len(req.tokens) + req.max_new_tokens - 1

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        need, cap = self._need_tokens(req), self.engine._cap()
        if need > cap:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.tokens)} + budget "
                f"{req.max_new_tokens} needs {need} cache tokens but engine capacity is {cap}")
        pool = self.engine.pool
        if pool is not None:
            pages = pages_needed(need, self.engine.ecfg.policy.buffer_size)
            most = min(pool.n_pages - 1, pool.n_chunks)
            if pages > most:
                raise ValueError(
                    f"request {req.rid}: needs {pages} pool pages but the engine can ever "
                    f"allocate at most {most} to one slot")
        self.queue.append(req)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        ecfg = self.engine.ecfg
        return sample(logits[:, -1], ecfg.temperature, ecfg.top_k, self._gen).cpu().numpy()

    def run_continuous(self) -> list[Result]:
        """Drain the queue with slot-level continuous batching.  Greedy
        (temperature 0) tokens of a request do not depend on what shares
        the batch."""
        eng = self.engine
        B = eng.ecfg.batch
        eos = eng.ecfg.eos_id
        view = eng.new_view()
        # the trie's counters are lifetime totals: snapshot them (after
        # new_view, which re-keys a paged engine's trie) to report this run's
        pstats0 = eng.prefix_cache.snapshot() if eng.prefix_cache is not None else None
        results: list[Result] = []
        pos = np.zeros(B, np.int32)        # per-slot absolute decode position
        budget = np.zeros(B, np.int32)
        done = np.ones(B, bool)            # per-slot idle flag
        fresh = np.ones(B, bool)           # slot's cache row is in the empty state
        reqs: list[Request | None] = [None] * B
        toks_buf: list[list[int]] = [[] for _ in range(B)]
        cur = np.zeros(B, np.int32)        # last sampled token per slot
        prefill_s = np.zeros(B)
        decode_s = np.zeros(B)
        steps = 0
        waited = set()                     # rids a decode step ran without, for want of pages
        wait_steps = 0                     # decode steps run with such a request waiting
        t_decode_total = 0.0
        t_all = time.time()

        def finish(s: int) -> None:
            r = reqs[s]
            results.append(Result(
                rid=r.rid, tokens=_truncate_eos(np.asarray(toks_buf[s], np.int32), eos),
                prefill_s=float(prefill_s[s]), decode_s=float(decode_s[s])))
            reqs[s] = None
            done[s] = True
            cur[s] = 0

        def splice(s: int) -> bool:
            r = self.queue[0]
            prompt = np.asarray(r.tokens, np.int32)[None]   # raw, unpadded
            t0 = time.time()
            try:
                logits = view.prefill_slot({"tokens": prompt}, s,
                                           admit=self.prefix_admission == "all",
                                           reserve_tokens=self._need_tokens(r))
            except PoolExhausted:
                return False               # stays at the head until pages come back
            self.queue.popleft()
            first = int(self._sample(logits)[0])
            prefill_s[s] = time.time() - t0
            fresh[s] = False
            reqs[s] = r
            toks_buf[s] = [first]
            cur[s] = first
            pos[s] = prompt.shape[1]
            budget[s] = r.max_new_tokens
            decode_s[s] = 0.0
            done[s] = False
            if r.max_new_tokens <= 1 or (eos >= 0 and first == eos):
                finish(s)
            return True

        while self.queue or not bool(done.all()):
            for s in range(B):
                while done[s] and self.queue and view.can_admit(self._need_tokens(self.queue[0])):
                    if not splice(s):
                        break
                if done[s] and not fresh[s]:
                    # queue drained: clear the slot so it idles on an empty row
                    view.reset_slot(s)
                    fresh[s] = True
                    pos[s] = 0
                    cur[s] = 0
            if bool(done.all()):
                if not self.queue:
                    break
                need = self._need_tokens(self.queue[0])
                # every slot is idle yet the head does not fit: the pool's
                # other pages are held by the prefix trie, so evict trie
                # entries back into free pages (the reclaim valve)
                if view.can_admit(need) or view.reclaim(need):
                    continue
                raise RuntimeError(f"request {self.queue[0].rid} cannot be admitted "
                                   "with every slot idle, and reclaim freed too little")
            if self.queue and bool(done.any()):
                # a free slot decodes empty because the head's pages are not free
                waited.add(self.queue[0].rid)
                wait_steps += 1
            t0 = time.time()
            logits = view.decode({"tokens": cur[:, None].copy()}, pos)
            nxt = self._sample(logits)
            step_t = time.time() - t0
            t_decode_total += step_t
            steps += 1
            pos += 1  # idle slots advance harmlessly; a splice rewrites pos[s]
            for s in np.nonzero(~done)[0]:
                decode_s[s] += step_t
                tok = int(nxt[s])
                toks_buf[s].append(tok)
                cur[s] = tok
                if (eos >= 0 and tok == eos) or len(toks_buf[s]) >= budget[s]:
                    finish(s)

        self.last_stats = {
            "wall_s": time.time() - t_all,
            "decode_s": t_decode_total,
            "decode_steps": steps,
            "tokens": int(sum(len(r.tokens) for r in results)),
            "attend_path": eng.attend_path,
            "layout": str(eng.ecfg.layout),
            "statuses": dict(Counter(str(r.status) for r in results)),
            "waited_for_pages": len(waited),
            "page_wait_steps": wait_steps,
        }
        if eng.pool is not None:
            self.last_stats["pool"] = eng.pool.snapshot()
        if pstats0 is not None:
            pstats = eng.prefix_cache.snapshot()
            hit = pstats.hit_chunks - pstats0.hit_chunks
            look = pstats.lookup_chunks - pstats0.lookup_chunks
            self.last_stats["prefix_hit_rate"] = hit / max(look, 1)
            self.last_stats["prefill_toks_saved"] = (
                pstats.prefill_toks_saved - pstats0.prefill_toks_saved)
            self.last_stats["prefix_evictions"] = pstats.evictions - pstats0.evictions
            self.last_stats["prefix_expiries"] = pstats.expiries - pstats0.expiries
            self.last_stats["prefix_version_evictions"] = (
                pstats.version_evictions - pstats0.version_evictions)
            self.last_stats["prefix"] = pstats
        return results


def _truncate_eos(tokens: np.ndarray, eos_id: int) -> np.ndarray:
    """Trim generated ids at the request's own first EOS (kept inclusive)."""
    if eos_id < 0:
        return tokens
    hits = np.nonzero(tokens == eos_id)[0]
    return tokens[: hits[0] + 1] if hits.size else tokens
