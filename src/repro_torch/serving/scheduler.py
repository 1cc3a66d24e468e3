"""Request-level batching scheduler over one :class:`Engine` (port of
``repro.serving.scheduler``).

Two modes over the engine's static batch of B slots:

* :meth:`Scheduler.run` — wave batching: queued requests are left-padded
  into waves of B (to the wave's longest raw prompt), each wave is prefilled
  at once and decodes in lockstep until every member is done
  (:meth:`Engine.generate`; dense layout only).
* :meth:`Scheduler.run_continuous` — slot-level continuous batching: a step
  loop decodes all B slots with per-slot positions; the moment a slot's
  request reaches its EOS or budget, the next queued request is prefilled
  at batch 1 (its raw prompt; the engine buckets it) and spliced into that
  slot while the others keep decoding.  On the paged layout a request is
  admitted only when the pool holds the pages of its lifetime; until then it
  waits at the queue head.  With a prefix cache, the scheduler's admission
  policy (``prefix_admission``) reaches every slot prefill, a paged engine
  whose slots are all idle while the head still does not fit reclaims trie
  pages (the reclaim valve), and ``last_stats`` reports the run's prefix
  counters.

Both modes trim each request's tokens at its own first EOS, and every
submitted request ends with exactly one typed :class:`Result`: retries with
backoff (:class:`~repro_torch.serving.resilience.RetryPolicy`), deadlines,
load shedding at submit (:class:`~repro_torch.serving.resilience.AdmissionValve`),
numeric quarantine and an attached fault injector
(:mod:`repro_torch.serving.faults`) resolve into ``OK`` / ``DEGRADED`` /
``TIMEOUT`` / ``REJECTED`` / ``FAILED``.  When the engine has telemetry
(``engine.obs``), the scheduler drives its request traces and counters.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque

import numpy as np
import torch

from repro_torch.core.cache import NumericFault
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.pagedpool import PoolExhausted, pages_needed
from repro_torch.serving.resilience import AdmissionValve, RequestStatus, RetryPolicy
from repro_torch.serving.sampling import sample

__all__ = ["Request", "Result", "Scheduler"]

_EMPTY = np.zeros(0, np.int32)


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # [prompt_len] int32
    max_new_tokens: int = 64
    # seconds from submit until the request times out (scheduler clock);
    # None: no deadline.  A queued request past it ends TIMEOUT with no
    # tokens, a running one keeps the tokens generated before the cutoff
    deadline_s: float | None = None


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray            # generated ids, truncated at first EOS
    prefill_s: float
    decode_s: float
    # typed terminal state; OK and DEGRADED carry the same tokens, DEGRADED
    # only flags a retried admission or decode step
    status: RequestStatus = RequestStatus.OK
    attempts: int = 1             # admission attempts consumed (1: clean)
    error: str = ""               # cause of a non-OK status


class Scheduler:
    """Request queue + batching over one engine; per-run aggregates land in
    :attr:`last_stats`.

    ``prefix_admission`` is "all" (every request's newly closed prompt
    chunks enter the trie) or "off" (cached prefixes are reused, nothing
    new is admitted).  ``seed`` seeds the sampling generator (temperature
    above 0; greedy decoding ignores it).  Resilience knobs, as in the
    reference: ``retry`` bounds admission and decode-step retries,
    ``valve`` sheds at submit, ``faults`` attaches a
    :class:`~repro_torch.serving.faults.FaultInjector` (wired into the
    engine and its pool), ``clock`` / ``sleep`` drive deadlines and backoff
    (default: the injector's fake clock when it has one, else
    ``time.monotonic`` / ``time.sleep``); the time stats are wall time."""

    def __init__(self, engine: Engine, seed: int = 0, prefix_admission: str = "all",
                 retry: RetryPolicy | None = None, valve: AdmissionValve | None = None,
                 faults=None, clock=None, sleep=None):
        if prefix_admission not in ("all", "off"):
            raise ValueError(f"prefix_admission must be all/off, got {prefix_admission!r}")
        self.engine = engine
        self.prefix_admission = prefix_admission
        self.retry = RetryPolicy() if retry is None else retry
        self.valve = AdmissionValve() if valve is None else valve
        self._faults = faults
        if faults is not None:
            engine.attach_faults(faults)
            if clock is None:
                clock = faults.clock
        self._clock = time.monotonic if clock is None else clock
        self._sleep = sleep if sleep is not None else getattr(clock, "sleep", time.sleep)
        # the engine's telemetry hub; its tracer follows the scheduler's clock
        # so spans line up with deadlines and backoff
        self.obs = engine.obs
        if self.obs is not None:
            self.obs.tracer.clock = self._clock
        self.queue: deque[Request] = deque()
        self.last_stats: dict = {}
        self.submitted_rids: list[int] = []
        self._submit_t: dict[int, float] = {}
        self._shed: list[Result] = []
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)

    def _need_tokens(self, req: Request) -> int:
        """Cache tokens the request's lifetime holds: prompt + one appended
        token per decode step (the first token comes from prefill).  A paged
        admission reserves exactly these pages."""
        return len(req.tokens) + req.max_new_tokens - 1

    def submit(self, req: Request) -> None:
        """Queue a request.  One that can never fit (engine capacity, or a
        paged pool with every page free) raises ``ValueError``; beyond the
        valve's ``max_queue`` it becomes an immediate ``REJECTED`` result,
        delivered by the next run."""
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
                    f"allocate at most {most} to one slot ({pool.n_pages - 1} allocatable, "
                    f"{pool.n_chunks} block-table entries)")
        self.submitted_rids.append(req.rid)
        self._submit_t[req.rid] = self._clock()
        o = self.obs
        if self.valve.shed(len(self.queue)):
            self._shed.append(Result(
                rid=req.rid, tokens=_EMPTY, prefill_s=0.0, decode_s=0.0,
                status=RequestStatus.REJECTED, attempts=0,
                error=f"shed at submit: queue at max_queue={self.valve.max_queue}"))
            if o is not None:
                o.on_shed(req.rid)
                o.result(str(RequestStatus.REJECTED))
            return
        self.queue.append(req)
        if o is not None:
            o.on_submit(req.rid)
            o.queue_depth(len(self.queue))

    def _drain_shed(self) -> list[Result]:
        out, self._shed = self._shed, []
        return out

    def audit(self, results: list[Result]) -> dict:
        """Post-run invariant report, never raises: every submitted rid
        ended with exactly one result (``results``: everything this
        scheduler's runs returned), plus the engine's pool and trie audit."""
        counts = Counter(r.rid for r in results)
        issues = [f"rid {rid}: {counts.get(rid, 0)} results (want 1)"
                  for rid in self.submitted_rids if counts.get(rid, 0) != 1]
        submitted = set(self.submitted_rids)
        issues += [f"rid {rid}: result without a submit" for rid in counts if rid not in submitted]
        eng_report = self.engine.audit()
        issues += eng_report["issues"]
        return {"ok": not issues, "issues": issues, "engine": eng_report}

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        ecfg = self.engine.ecfg
        return sample(logits[:, -1], ecfg.temperature, ecfg.top_k, self._gen).cpu().numpy()

    # ------------------------------------------------------------------
    # Wave mode
    def run(self) -> list[Result]:
        """Drain the queue in engine-batch-sized waves.  A wave shares one
        full-batch prefill, so its prompts are left-padded to its longest raw
        prompt (a short wave is filled with copies of its first request,
        left out of the results and of the throughput); left padding shifts
        chunk boundaries, so a request's numerics depend on its wave."""
        results: list[Result] = self._drain_shed()
        B = self.engine.ecfg.batch
        eos = self.engine.ecfg.eos_id
        t_all = time.time()
        while self.queue:
            wave = [self.queue.popleft() for _ in range(min(B, len(self.queue)))]
            while len(wave) < B:                      # pad with a copy slot
                wave.append(Request(rid=-1, tokens=wave[0].tokens,
                                    max_new_tokens=wave[0].max_new_tokens))
            wave_pad = max(len(r.tokens) for r in wave)
            prompts = np.stack([_pad(np.asarray(r.tokens, np.int32), wave_pad) for r in wave])
            budget = max(r.max_new_tokens for r in wave)
            toks, stats = self.engine.generate({"tokens": prompts}, budget, generator=self._gen,
                                               active=np.array([r.rid >= 0 for r in wave]))
            for i, r in enumerate(wave):
                if r.rid < 0:
                    continue
                res = Result(rid=r.rid, tokens=_truncate_eos(toks[i, : r.max_new_tokens], eos),
                             prefill_s=stats["prefill_s"], decode_s=stats["decode_s"])
                results.append(res)
                if self.obs is not None:
                    self.obs.result(str(res.status))
                    self.obs.tracer.finish(r.rid, str(res.status))
        self.last_stats = {"wall_s": time.time() - t_all,
                           "tokens": int(sum(len(r.tokens) for r in results)),
                           "statuses": dict(Counter(str(r.status) for r in results))}
        return results

    # ------------------------------------------------------------------
    # Continuous mode
    def run_continuous(self) -> list[Result]:
        """Drain the queue with slot-level continuous batching.  Greedy
        (temperature 0) tokens of a request do not depend on what shares
        the batch.

        Every submitted request ends with exactly one :class:`Result`.  A
        failed admission (:class:`~repro_torch.serving.pagedpool.PoolExhausted`)
        retries at most ``retry.max_attempts`` times with backoff, then ends
        ``REJECTED``, also when every slot is idle and the reclaim valve
        frees too little; a NaN/Inf-poisoned prefill
        (:class:`~repro_torch.core.cache.NumericFault`) fails only that
        request, the engine having rolled its reservation back; deadlines
        end ``TIMEOUT`` with the tokens generated so far.

        The decode caches advance in place (the reference donates them), so
        only faults raised *before* a step is dispatched are retried: the
        injector's ``check_step`` faults, bounded, after which a prefill
        fault fails its request and a decode fault every active slot.  An
        exception raised inside a step is not retried: it propagates, as in
        the reference."""
        eng = self.engine
        B = eng.ecfg.batch
        eos = eng.ecfg.eos_id
        results: list[Result] = self._drain_shed()
        view = eng.new_view()
        # the trie's counters are lifetime totals: snapshot them (after
        # new_view, which re-keys a paged engine's trie) to report this run's
        pstats0 = eng.prefix_cache.snapshot() if eng.prefix_cache is not None else None
        obs = self.obs
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
        attempts: dict[int, int] = {}      # failed admissions per rid
        degraded: set[int] = set()         # completed-but-impaired rids
        not_before = 0.0                   # admission backoff gate (scheduler clock)
        dec_faults = 0                     # consecutive failed decode steps

        def expired(r: Request) -> bool:
            return (r.deadline_s is not None
                    and self._clock() - self._submit_t.get(r.rid, 0.0) > r.deadline_s)

        def terminal(r: Request, status: RequestStatus, error: str, tokens=_EMPTY) -> None:
            """A non-completion result for a request not in a slot."""
            results.append(Result(rid=r.rid, tokens=np.asarray(tokens, np.int32),
                                  prefill_s=0.0, decode_s=0.0, status=status,
                                  attempts=attempts.get(r.rid, 0), error=error))
            if obs is not None:
                obs.result(str(status))
                if error:
                    obs.tracer.event(r.rid, "terminal", error=error)
                obs.tracer.finish(r.rid, str(status))

        def reap_expired_queue() -> None:
            """Queued requests past their deadline: empty TIMEOUT results."""
            for _ in range(len(self.queue)):
                r = self.queue.popleft()
                if expired(r):
                    terminal(r, RequestStatus.TIMEOUT,
                             f"deadline {r.deadline_s}s elapsed while queued")
                else:
                    self.queue.append(r)

        def finish(s: int, status: RequestStatus | None = None, error: str = "") -> None:
            r = reqs[s]
            if status is None:
                status = (RequestStatus.DEGRADED if attempts.get(r.rid, 0) or r.rid in degraded
                          else RequestStatus.OK)
            results.append(Result(
                rid=r.rid, tokens=_truncate_eos(np.asarray(toks_buf[s], np.int32), eos),
                prefill_s=float(prefill_s[s]), decode_s=float(decode_s[s]),
                status=status, attempts=attempts.get(r.rid, 0) + 1, error=error))
            if obs is not None:
                obs.result(str(status))
                obs.tracer.add_span(r.rid, "decode", float(decode_s[s]), steps=len(toks_buf[s]))
                if error:
                    obs.tracer.event(r.rid, "terminal", error=error)
                obs.tracer.finish(r.rid, str(status))
            reqs[s] = None
            done[s] = True
            cur[s] = 0

        def admit_failed(r: Request, exc: Exception, status: RequestStatus) -> bool:
            """Bounded-retry bookkeeping of a failed admission: True when the
            request ended (``status``), False when it went back to the queue
            head to retry after its backoff."""
            nonlocal not_before
            attempts[r.rid] = attempts.get(r.rid, 0) + 1
            if obs is not None:
                obs.retry("admission")
                obs.tracer.event(r.rid, "retry", kind="admission", attempt=attempts[r.rid],
                                 error=str(exc))
            if attempts[r.rid] >= self.retry.max_attempts:
                terminal(r, status, f"admission failed {attempts[r.rid]}x: {exc}")
                return True
            self.queue.appendleft(r)
            not_before = self._clock() + self.retry.backoff(attempts[r.rid])
            return False

        def splice(s: int) -> bool:
            """Admit the queue head into idle slot ``s``.  True when the slot
            may have changed (spliced, or the head ended: the admission loop
            may try the next request); False when the head was requeued."""
            r = self.queue.popleft()
            if expired(r):
                terminal(r, RequestStatus.TIMEOUT, f"deadline {r.deadline_s}s elapsed while queued")
                return True
            prompt = np.asarray(r.tokens, np.int32)[None]   # raw, unpadded
            if obs is not None:
                tr = obs.tracer.active.get(r.rid)
                if tr is not None:
                    obs.observe_queue_wait(max(self._clock() - tr.t_submit, 0.0))
                obs.tracer.end(r.rid)              # close "queued"
                obs.tracer.attempt(r.rid)
                obs.tracer.begin(r.rid, "prefill", attempt=attempts.get(r.rid, 0) + 1, slot=s)
                obs.tracer.bind(r.rid)
            t0 = time.time()
            try:
                if self._faults is not None:
                    self._faults.check_step("prefill")
                logits = view.prefill_slot({"tokens": prompt}, s,
                                           admit=self.prefix_admission == "all",
                                           reserve_tokens=self._need_tokens(r))
            except PoolExhausted as e:
                # the pool (or the injector) refused the reservation before
                # any device work: bounded retry, then REJECTED
                return admit_failed(r, e, RequestStatus.REJECTED)
            except NumericFault as e:
                # quarantine: the engine rolled its reservation back and never
                # touched the shared tree; only this request fails
                attempts[r.rid] = attempts.get(r.rid, 0) + 1
                terminal(r, RequestStatus.FAILED, f"numeric quarantine: {e}")
                return True
            except InjectedFault as e:
                # raised before the step was dispatched: bounded retry (the
                # request then completes DEGRADED), then FAILED
                degraded.add(r.rid)
                return admit_failed(r, e, RequestStatus.FAILED)
            finally:
                if obs is not None:
                    obs.tracer.unbind()
                    obs.tracer.end(r.rid)          # close "prefill"
            first = int(self._sample(logits)[0])
            prefill_s[s] = time.time() - t0
            if obs is not None:
                obs.observe_prefill(float(prefill_s[s]))
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

        def head_ready() -> bool:
            """May the queue head try admission now: past its backoff, and
            the view has room for its lifetime."""
            return (self._clock() >= not_before
                    and view.can_admit(self._need_tokens(self.queue[0])))

        while self.queue or not bool(done.all()):
            if self._faults is not None:
                self._faults.tick(eng)
            reap_expired_queue()
            for s in range(B):
                while done[s] and self.queue and head_ready():
                    if not splice(s):
                        break
                if done[s] and not fresh[s]:
                    # queue drained (or head inadmissible): clear the slot so
                    # it idles on an empty row (paged: releases its pages)
                    view.reset_slot(s)
                    fresh[s] = True
                    pos[s] = 0
                    cur[s] = 0
            if bool(done.all()):
                if not self.queue:
                    break
                now = self._clock()
                if now < not_before:
                    self._sleep(not_before - now)  # idle inside a backoff window
                    continue
                # every slot is idle yet the head does not fit: the pool's
                # other pages are held by the prefix trie, so evict trie
                # entries back into free pages (the reclaim valve); when that
                # frees too little, bounded attempts end the head REJECTED
                r = self.queue[0]
                need = self._need_tokens(r)
                if view.reclaim(need) or view.can_admit(need):
                    continue
                self.queue.popleft()
                if not admit_failed(r, PoolExhausted(
                        f"need {need} tokens, idle engine, reclaim freed nothing"),
                        RequestStatus.REJECTED):
                    self._sleep(max(not_before - self._clock(), 0.0))
                continue
            if self._faults is not None:
                try:
                    self._faults.check_step("decode")
                except InjectedFault as e:
                    # raised before the step is dispatched: the caches are
                    # untouched, so the step can be retried
                    dec_faults += 1
                    active = list(np.nonzero(~done)[0])
                    if obs is not None:
                        obs.retry("decode")
                        for s in active:
                            obs.tracer.event(reqs[s].rid, "retry", kind="decode",
                                             attempt=dec_faults)
                    if dec_faults >= self.retry.max_attempts:
                        for s in active:
                            finish(s, status=RequestStatus.FAILED,
                                   error=f"decode failed {dec_faults}x: {e}")
                        dec_faults = 0
                    else:
                        degraded.update(reqs[s].rid for s in active)
                        self._sleep(self.retry.backoff(dec_faults))
                    continue
                dec_faults = 0
            if self.queue and bool(done.any()):
                # a free slot decodes empty while the queue head waits
                waited.add(self.queue[0].rid)
                wait_steps += 1
            t0 = time.time()
            logits = view.decode({"tokens": cur[:, None].copy()}, pos)
            nxt = self._sample(logits)
            step_t = time.time() - t0
            t_decode_total += step_t
            steps += 1
            pos += 1  # idle slots advance harmlessly; a splice rewrites pos[s]
            active_slots = np.nonzero(~done)[0]
            if obs is not None:
                obs.decode_step(step_t, len(active_slots))
                obs.queue_depth(len(self.queue))
            for s in active_slots:
                decode_s[s] += step_t
                if obs is not None:
                    obs.tracer.step(reqs[s].rid)
                tok = int(nxt[s])
                toks_buf[s].append(tok)
                cur[s] = tok
                if (eos >= 0 and tok == eos) or len(toks_buf[s]) >= budget[s]:
                    finish(s)
                elif expired(reqs[s]):
                    finish(s, status=RequestStatus.TIMEOUT,
                           error=f"deadline {reqs[s].deadline_s}s elapsed mid-decode")

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
        if obs is not None:
            # fold the pool's and trie's lifetime counters into the registry
            # by delta (a paged new_view rebuilds both and zeroes them)
            if eng.pool is not None:
                obs.sync_pool(self.last_stats["pool"])
            if eng.prefix_cache is not None:
                obs.sync_prefix(eng.prefix_cache.snapshot())
            obs.queue_depth(len(self.queue))
        return results


def _truncate_eos(tokens: np.ndarray, eos_id: int) -> np.ndarray:
    """Trim generated ids at the request's own first EOS (kept inclusive)."""
    if eos_id < 0:
        return tokens
    hits = np.nonzero(tokens == eos_id)[0]
    return tokens[: hits[0] + 1] if hits.size else tokens


def _pad(tokens: np.ndarray, length: int) -> np.ndarray:
    """Left-pad (or left-truncate) to ``length``: wave mode's per-wave prompt
    alignment; continuous mode sends raw prompts instead."""
    if len(tokens) >= length:
        return tokens[-length:]
    return np.pad(tokens, (length - len(tokens), 0))
