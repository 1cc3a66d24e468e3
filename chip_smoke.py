#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--parent-scan OLD/linear_scan.cu]
                          [--parent-kernels OLD_CSRC_DIR]

Phases, each of which fails the run (non-zero exit) on any error:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: ``nvcc`` compiles every ``src/repro_torch/kernels/csrc/*.cu``, one
   process per source, in parallel;
3. ``gear_decode`` against its plain PyTorch version at the main path's
   shapes (4 slots, 32 kv heads, head_dim 128, capacity 1152) for
   gear_kcvt4 and gear_kivi2, with ragged extents and a constant
   channel / token whose outlier index is stored twice; again at hymba's
   shape (5 kv heads with G = 5 query rows each, head_dim 64); then at the
   streaming history scorer's shape (G * T = 64 query rows per row of a
   batch-1 cache, one shared extent: the kernel's tensor-core regime); then
   ``gear_decode_history`` over request 0's 14 in-flight blocks in one
   launch (its layer-0 history work), against its plain version and, bit
   for bit, the 14 per-block calls, timed (``ms_history_per_layer_synthetic``);
   head_dim 256: gemma-2b's live shape (4 slots x 1 kv head, G = 8) for both
   policies, timed (``ms_gemma``, ``ms_gemma_kivi2``), and gemma3-12b's G = 2;
   starcoder2-3b's G = 12 at head_dim 128 (the decode regime's 16-row
   build, ``ms_starcoder2``) beside the same operands through the
   tensor-core history body (``ms_starcoder2_history``); qwen3-moe's G = 16
   over 4 kv heads at head_dim 128 for both policies (``ms_qwen3``,
   ``ms_qwen3_kivi2``, each also through the history body) and llama4-scout's
   G = 5 over 8 kv heads (``ms_llama4``); the history scorer
   at head_dim 256 (one kv head, 14 blocks x 512 query rows) with 1 and 4 V
   stat groups (gear_kcvt4, gear_kivi2), against plain and per-block calls;
4. ``flash_prefill`` against its plain version (S = 1024, a ragged S = 1000,
   kv_repeat = 4, window + softcap, a bidirectional prefix, and hymba's
   25 query heads over 5 kv heads at head_dim 64; head_dim 256 at gemma-2b's
   kv_repeat 8, also with window + softcap and a 256-token prefix;
   starcoder2-3b's kv_repeat 12; qwen3-moe's 64 query heads over 4 kv heads
   (kv_repeat 16) and llama4-scout's 40 over 8 (kv_repeat 5) at head_dim
   128), with
   ``torch.nn.functional.scaled_dot_product_attention`` timed beside it;
5. ``gear_compress`` against its plain version, bit for bit (packed codes,
   stats, outlier values and indices, residual; two calls bitwise equal),
   for both policies, K and V orientation, over the B * H * C' = 448
   [64, 128] tiles a 900-token prompt closes per layer, each timed (for
   gear_kcvt4's K, also without outliers and beside a device copy of x);
6. ``flash_prefill_block`` against its plain version (two calls bitwise
   equal): 448 row-groups of T = 64 (kv_len = 64), kv_repeat 4, and a
   ragged tail (T = 37, random kv_len), each timed; at T = 64 beside
   ``torch.ops.aten._scaled_dot_product_efficient_attention`` with the
   causal and kv_len mask as an additive bias (its (out, lse) held against
   (acc / l, m + log l) first), a yardstick the port never calls, and
   on one full wave of row groups (3 per SM) and on one row group alone;
   with ``--parent-kernels``, a parent tree's ``flash_prefill_block.cu``,
   ``gear_compress.cu`` and ``quant_pack.cu`` are built too and timed in
   turns p1, c1, c2, p2 here, in phases 5 and 9 and at phase 11's live
   calls;
7. ``gear_decode_paged`` against its plain version, and bit for bit against
   ``gear_decode`` on the gathered operands, over a shuffled pool of the
   main path's shapes whose tables name the zero page past each extent, and
   of gemma-2b's (1 kv head of 256, G = 8);
8. ``linear_scan_chunked`` against its plain version (y and final state):
   hymba's SSM heads (25 rows, Dk 16, Dv 64, one decay per head) at an
   aligned S = 1024 in chunks of 64, at the live S = chunk = 859, per-Dk
   decay at S = chunk = 200, and the ``bonus`` mode at RWKV6-3b's head
   shape (Dk = Dv = 64, per-Dk decay): 40 rows in chunks of 64, the live
   prefill's S = chunk = 859, and the decode step's S = chunk = 1 over 160
   rows (4 slots x 40 heads) from a non-zero initial state (the step
   regime; the others run the chunked regime's three launches); each case
   held globally and per row, two calls bit for bit, timed beside its f32
   bound and, where products run on the tensor cores, its TF32 bound, with
   the CUDA kernels one call launches (with ``--parent-scan``, an older
   ``linear_scan.cu`` is built too and timed in turns p1, c1, c2, p2 here
   and at the live scans of phases 13 and 15); then the backward
   (``linear_scan_chunked_bwd``) at every one of those cases (a seeded dy,
   and a seeded final-state gradient from a ``state0``) and at paths 25-26's
   training scans (rwkv6-3b: 80 rows of Dk = Dv = 64, bonus; hymba-1.5b: 50
   rows, Dk 16, Dv 64, one decay per row; S 512 in chunks of 64, a zero
   final-state gradient): every gradient within 2e-3 x max(1, max |plain|)
   of ``linear_scan_bwd_ref``'s overall and per row, two calls bit for bit,
   timed beside the plain version, its f32 bound and its bound with the
   tensor-core products at the TF32 rate, with each CUDA kernel's time (a
   profiler window) (with ``--parent-scan``, a parent
   library's backward too, in turns, here and at the live backward calls of
   phases 36-37, its gradients held to the same limit), and the pair
   kernel's blocks per SM;
9. ``quant_pack`` through its entry point ``repro_torch.kernels.quantize_chunk``
   on the 448 [64, 128] tiles of phase 5, at 2, 4 and 8 bits, f32 and bf16
   input: launches counted, packed codes, scale and zero bit for bit equal
   to the plain version, also on non-finite input (NaN, +-inf, an all-NaN
   tile; NaN compared as equal) and across two calls; timed at 448 [64,
   128] tiles (4 bits f32 and bf16, 2 and 8 bits f32) and 448 [64, 64]
   (hymba's head_dim) beside its byte bound, the profiler's kernel time, the
   plain version and ``torch.aminmax`` (a read-side yardstick); with
   ``--parent-kernels`` the parent's ``quant_pack.cu`` in turns too;
10. serving, path 1: llama2-7b at full width (``--layers`` of its 32 layers)
   with random bf16 weights from a seeded generator, gear_kcvt4,
   ``Engine(batch=4, capacity=1152)`` (monolithic prefill, dense layout) and
   ``Scheduler.run_continuous`` over 8 requests; the launch counters must
   show ``gear_decode`` and ``flash_prefill`` on the path, and the live
   layer-0 cache of one decode step is held against the plain version, and
   the timer's own check runs on it (CUDA events beside the profiler's
   kernel time); path 10b: that step's layer-0 ``gear_attend`` output (the
   kernel) against the portable ``cache.attend`` on the same cache (atol
   3e-2, the reference's bound for its f32 / bf16 pair) (no profiler
   window, for time: ``PERF.md`` §5 keeps an earlier reading);
10.1. serving on a device mesh, path 29: path 1's model and weights through
    ``Engine(..., mesh=make_test_mesh(1, 1))`` (one NCCL process; every
    axis of size 1, so every parameter is shared with path 1's model and no
    collective is issued), gear_kcvt4, monolithic prefill, dense layout,
    path 1's first 4 requests, 32 new tokens each: greedy tokens equal to
    the first 32 of path 1's, bit for bit,
    exactly path 1's ``flash_prefill`` launches per prefill and
    ``gear_decode`` launches per step and no other kernel, no
    ``torch.distributed`` collective called; decode tok/s and peak memory
    beside path 1's (its launcher run is in phase 21);
10.2. sampled serving on path 1's model: on one live decode step's
    final-position logits [4, 32000] of path 1 (decode step 40), the
    reference's ``jax.random`` stream drawn on the card
    (``repro_torch.core.prng``) equals the CPU's bit for bit in ``bits``
    (``gumbel`` reported), and ``sample`` at temperature 0.8 with ``top_k``
    0 and 40 gives the CPU sampler's ids on the same logits, except rows
    whose two best perturbed scores lie within ``SAMPLE_MARGIN`` (counted);
    the sampler's kernel launches and device time a call (one call a decode
    step); then path 29's 4 requests x 16 tokens through a second
    ``Engine`` over path 1's model (no new weights) at temperature 0.8,
    ``top_k`` 40: every request ``OK``, its full budget, ids in the
    vocabulary, path 1's kernels on the path;
11. serving, path 2: the same requests through llama2-7b at all its 32
    layers with ``prefill_mode="streaming", layout="paged"`` and a pool of
    two thirds of the dense-equivalent pages, so that a decode step runs
    while a request waits for pages (``--layers`` does not cut it); the
    counters must show ``gear_compress``, ``flash_prefill_block``,
    ``gear_decode`` (exactly one history launch per prefill and layer,
    ``gear_decode_history``) and ``gear_decode_paged`` on the path, each
    kernel's live layer-0 call is held against its plain version and timed
    (``gear_compress``: the K and the V event of request 0's layer 0, bit
    for bit; ``flash_prefill_block`` also beside the efficient-attention
    yardstick; request 0's layer-0 history call as ``ms_history_per_layer``)
    (no profiler window, for time: ``PERF.md`` §5 keeps an earlier reading);
12. serving, path 5: the prefix trie, on phase 11's llama2-7b (all 32
    layers) with ``prefill_mode="streaming", layout="paged",
    prefix_cache=True`` (first, layer 0's row-wise products checked for
    rows that do not depend on the row count): 8 requests sharing one 512-token system prompt,
    each with its own user suffix of raw length 40-400 (numpy seed 0), over
    a pool of 32 allocatable pages, small enough that the trie's retained
    pages block the queue head on an idle engine; request 1 must hit all 8
    system-prompt chunks, ``reclaim_pages`` must free pages at least once,
    the pool check and the engine audit (with the trie's retained pages)
    must pass, request 1's warm prefill must launch ``gear_compress`` only
    for its suffix's closed chunks, one history launch and one
    ``flash_prefill_block`` launch per layer and no ``flash_prefill``, and
    the same requests on an engine without the trie must give the same
    greedy tokens, and for request 1 the same prefill logits and pool
    chunks bit for bit; request 1's layer-0 history call (extents from 512)
    and ``flash_prefill_block`` call are held against their plain versions
    and timed, cold and warm prefill times are printed (no profiler window,
    for time: ``PERF.md`` §5 keeps an earlier reading);
13. serving, path 3: hymba-1.5b (GEAR attention beside Mamba-2 SSM heads)
    at its 32 layers and published widths, random bf16 weights with the
    reference's SSM constants, the same 8 requests (ids from its vocab),
    monolithic prefill on the dense layout; the counters must show 32
    ``linear_scan_chunked`` and 32 ``flash_prefill`` launches per prefill
    and 32 ``gear_decode`` launches per step; the live layer-0 scan (S =
    chunk = 859) and decode step are held against their plain versions and
    timed (no profiler window, for time);
14. serving, path 6: the same hymba-1.5b with streaming prefill (unbucketed,
    as the reference serves a hybrid) on the dense layout, 16 new tokens per
    request (cut from 96 for time); every prefill must launch 32
    ``flash_prefill_block``, 32 history, 32 ``linear_scan_chunked`` and 64
    ``gear_compress`` kernels and no ``flash_prefill``, every decode step 32
    ``gear_decode``; the live layer-0 K and V ``gear_compress`` calls
    (head_dim 64 tiles, bit for bit), ``flash_prefill_block`` call
    (kv_repeat 5, head_dim 64) and history call (5 heads x 64 = 320 query
    rows) are held against their plain versions and timed (no profiler
    window);
15. serving, path 4: rwkv6-3b (attention-free RWKV6, no KV cache) at its 32
    layers and published widths, random bf16 weights with the reference's
    constants, the same 8 requests (ids from its vocab), monolithic prefill
    on the dense layout; the counters must show exactly 32
    ``linear_scan_chunked`` launches per prefill and 32 per decode step (the
    step scans one token from each layer's state) and no attention kernel;
    the live layer-0 prefill scan (S = chunk = 859) and decode scan (S = 1,
    from the slots' states) are held against their plain versions and
    timed (no profiler window);
16. serving, path 7: wave mode on phase 10's llama2-7b at 8 of its layers
    (32 until path 29 came; ``--layers`` cuts it further):
    ``Engine(batch=4, capacity=1152)`` dense and ``Scheduler.run``
    over the 8 requests in two waves, left-padded to 859 and 899 tokens,
    each prefilled at batch 4 (``flash_prefill`` at BHq = 128) and decoded
    in lockstep; every request must end ``OK`` with 96 in-vocab tokens, each
    wave prefill launch exactly 8 ``flash_prefill`` and each decode step 8
    ``gear_decode``; the live layer-0 ``flash_prefill`` call (BHq 128) is
    held against its plain version and timed beside SDPA, one live decode
    step's layer-0 cache against the plain version, and each wave row's
    last-position prefill logits against a batch-1 prefill of the same
    left-padded prompt, bit for bit; a profiler window covers one wave
    prefill;
17. serving, path 8: path 5's engine and traffic (all 32 layers) with
    ``obs=ObsConfig()`` and a seeded ``FaultInjector`` on a ``FakeClock``
    whose schedule fires ``pool_exhausted``, ``prefill_error``,
    ``nan_chunk``, ``decode_error`` and ``trie_evict`` once each: exactly one
    result per rid and ``Scheduler.audit`` clean, the quarantined request
    ``FAILED``, every ``OK`` / ``DEGRADED`` request's greedy tokens bit for
    bit path 5's, one complete trace per rid, and the metrics counting each
    fired site;
18. serving, path 9: the paper's FP16 baseline, llama2-7b at all 32 layers
    with ``policy=fp16`` (monolithic prefill, dense layout, the path-1
    requests, 96 new tokens): every request ``OK``, 32 ``flash_prefill`` per
    prefill and no ``gear_decode`` or ``gear_compress`` launch; the live
    layer-0 decode attend of one step (the portable ``cache.attend``) held
    against an f64 softmax(q·Kᵀ)·V of the same FP16 cache; decode tok/s,
    prefill ms, peak memory and ``Engine.cache_nbytes`` printed beside path
    1's gear_kcvt4 readings;
19. serving, path 10a: per_token_q4 (per-token-group K, not the kernels'
    layout), monolithic prefill, the paged layout with path 2's pool, 16 new
    tokens: every request ``OK``, no ``gear_decode`` / ``gear_decode_paged``
    launch, and the live layer-0 ``attend_paged`` output equal, bit for bit,
    to ``attend`` on the gathered dense cache;
20. serving, path 11: path 5's engine and traffic twice more, with
    ``obs=ObsConfig()`` (telemetry on; its wall beside path 5's) and with
    ``obs=ObsConfig(fidelity_every_n=1)`` (the fidelity probes): tokens bit
    for bit path 5's in both; no probe error, at least one probe, every
    layer in a report with finite K/V errors, 32 ``flash_prefill`` launches
    (the FP16 shadow prefill) per probe;
21. the launcher: ``python -m repro_torch.launch.serve`` at full width,
    three subprocesses with no ``--device`` started together: wave mode
    (batch 4, prompt 512, 16 tokens), continuous + paged mode with
    ``--obs``, ``--metrics-json`` and ``--trace-out`` under
    ``build/serve/``, and path 29's wave mode with ``--mesh 1x1``; each must
    exit 0 and print the reference launcher's lines, and both JSON files
    must parse;
22. serving, path 12: gemma-2b at its published widths (18 layers, d_model
    2048, 8 heads over 1 kv head of 256, d_ff 16384, GeGLU, vocab 256000
    tied and scaled by sqrt(d_model)), gear_kcvt4, monolithic prefill, dense
    layout, the path-1 requests (ids from its vocab), 96 new tokens: every
    request ``OK``, exactly 18 ``flash_prefill`` (head_dim 256, kv_repeat 8)
    per prefill and 18 ``gear_decode`` (G = 8, head_dim 256) per step and
    no other kernel; request 0's live layer-0 ``flash_prefill`` call (beside
    SDPA) and a live decode step held against their plain versions and
    timed (no profiler window, for time; ``PERF.md`` §5 keeps an earlier
    reading);
23. serving, path 13: the same gemma-2b, gear_kivi2 (4 V stat groups),
    streaming prefill into a paged pool of two thirds of the dense pages, 16
    new tokens (cut from 96, as on paths 14 and 15, for time; no profiler
    windows on paths 13-15): per prefill exactly 18 ``flash_prefill_block`` (kv_repeat
    8), 18 history and 36 ``gear_compress`` launches ([64, 256] tiles) and
    no ``flash_prefill``, 18 ``gear_decode_paged`` per step; the live K and
    V compression events bit for bit, the in-flight blocks (beside the
    efficient-attention yardstick), the history call (gv 4) and a paged step
    held against their plain versions and timed;
24. serving, path 14: starcoder2-3b at its published widths (30 layers,
    d_model 3072, 24 heads over 2 kv heads of 128, LayerNorm with bias,
    GELU MLP d_ff 12288, vocab 49152), as path 12 with 16 new tokens:
    ``flash_prefill`` at kv_repeat 12 and ``gear_decode`` at G = 12 in the
    decode regime;
25. serving, path 15: minicpm-2b at its published widths (40 layers,
    d_model 2304, 36 heads = 36 kv heads of 64, d_ff 5760, tied vocab
    122753), as path 14;
26. serving, path 16: gemma3-12b at its published widths (48 layers in
    units of 5 local + 1 global, d_model 3840, 16 heads over 8 kv heads of
    256, QK-norm, RoPE base 10,000 on local layers and 1e6 on global ones,
    local window 1024, GeGLU d_ff 15360, tied vocab 262144), gear_kcvt4,
    monolithic prefill, dense layout, batch 4, capacity 2048, 8 requests of
    1,100-1,900 tokens (numpy seed 0), 16 new tokens: every request ``OK``,
    per prefill exactly 48 ``flash_prefill`` (the 40 local ones with window
    1024) and no other kernel, per decode step exactly 8 ``gear_decode`` (G 2,
    head_dim 256; the 40 window rings decode through the portable
    ``cache.attend``); request 0's live layer-0 call (local, past its window)
    held against its plain version and timed beside SDPA with the window as a
    boolean mask, and a live global decode step against its plain version;
    profiler windows over one 1,100-token prefill and 8 decode steps;
27. serving, path 17: the same gemma3-12b, streaming prefill into a paged
    pool of two thirds of the dense pages, the first 4 of path 16's requests:
    8 pooled global layers beside 40 dense rings, a clean pool check and
    audit, per prefill 40 windowed ``flash_prefill`` (the local layers'
    monolithic fallback), 8 ``flash_prefill_block``, 8 history and 16
    ``gear_compress`` launches (the live K and V events on [64, 256] tiles
    bit for bit, timed), per step 8 ``gear_decode_paged``, and greedy tokens equal
    to a dense streaming engine's bit for bit;
28. serving, path 18: paligemma-3b at its published widths (18 layers,
    d_model 2048, 8 heads over 1 kv head of 256, GeGLU d_ff 16384, vocab
    257216, 256 image positions), gear_kcvt4, monolithic prefill, dense
    layout, capacity 1,280: (a) one wave through ``Engine.generate`` of 4
    seeded 600-token prompts behind seeded bf16 image embeddings [4, 256,
    2048], (b) path 1's 8 prompts through ``run_continuous`` (text only); in
    both 18 ``flash_prefill`` (prefix 256) per prefill and 18 ``gear_decode``
    (G 8) per step and no other kernel; the wave's live layer-0 prefix call
    held against its plain version and timed beside SDPA with the mask;
29. serving, path 19: musicgen-medium at its published widths and depth (48
    layers, d_model 1536, 24 heads = 24 kv heads of 64, LayerNorm, GELU MLP
    d_ff 6144, 4 codebooks of 2048, an untied head of 4 x 2048 logits),
    gear_kcvt4, monolithic prefill, dense layout, capacity 704: one wave
    through ``Engine.generate`` (the reference's only audio entry point) of 4
    prompts of 620 frames x 4 codebook ids (numpy seed 0) and 32 new frames:
    frames [4, 32, 4] in vocab, exactly 48 ``flash_prefill`` launches (BHq 96,
    Dh 64) for the wave's prefill and 48 ``gear_decode`` (G 1) per step, no
    other kernel; the live layer-0 prefill call held against its plain
    version and timed beside SDPA, a live decode step against its plain
    version; prefill ms, frames/s, peak memory;
30. serving, path 20: qwen3-moe-235b-a22b at its published widths (d_model
    4096, 64 heads over 4 kv heads of 128, QK-norm, 128 experts of 1536,
    top-8, untied vocab 151936) and 8 of its 94 layers (memory: the weights
    of ~15 layers fill the card; random bf16 weights, the router in f32),
    gear_kcvt4, monolithic prefill, dense layout, path 1's 8 requests (ids
    from its vocab), 16 new tokens: per prefill exactly 8 ``flash_prefill``
    (kv_repeat 16) and per step 8 ``gear_decode`` (G 16, every row of the
    16-row build), no other kernel; request 0's live layer-0 call (beside
    SDPA) and a live decode step held against their plain versions and
    timed; each prefill's dropped ``(token, k)`` pairs (capacity 72 at 859
    tokens), and decode tok/s beside the step's byte floor (every expert's
    weights are read on every step); profiler windows over one prefill and
    8 decode steps;
31. serving, path 21: llama4-scout-17b-a16e at its published widths
    (d_model 5120, 40 heads over 8 kv heads of 128, 16 experts of 8192,
    top-1, a shared expert, untied vocab 202048) and 8 of its 48 layers, as
    path 20: ``flash_prefill`` at kv_repeat 5 and ``gear_decode`` at G 5;
32. serving, path 22: path 21's model with streaming prefill into a paged
    pool of two thirds of the pages path 1's first 4 requests hold over
    their lifetimes, those 4 requests: a request waits for pages, a clean
    pool check and audit, per prefill 8 ``flash_prefill_block`` (kv_repeat
    5), 8 history and 16 ``gear_compress`` launches and no ``flash_prefill``,
    per step 8 ``gear_decode_paged``; the live K and V compression events
    bit for bit, the in-flight blocks (beside the efficient-attention
    yardstick), the history call and a paged step held against their plain
    versions and timed; greedy tokens equal to a dense streaming engine's
    bit for bit;
33. training, path 23: minicpm-2b at its published widths and 40 layers
    (2.72 B parameters; random f32 master weights from a seeded generator),
    the config's WSD schedule, remat per layer with the ``dots`` policy,
    batches of 4 x 512 tokens from ``repro_torch.data.synthetic`` in 2
    microbatches, 8 steps of ``make_train_step`` and no checkpoint: every
    loss and grad norm finite and positive, the last loss below the first,
    every kernel wrapper's launch counter 0 over the steps (training attends
    through ``attention_train``); step time, tokens/s, peak memory and the
    share of the dense bf16 peak that 8 N tokens per step reach;
34. training, path 24: the smoke configs of minicpm-2b, rwkv6-3b,
    hymba-1.5b, qwen3-moe-235b-a22b, paligemma-3b and musicgen-medium, one
    train step on the CPU port and on the card from the same weights and
    batch (loss within 1e-2; every update of >= 1,000 elements at cosine
    >= 0.98, but rwkv6-3b: its gradients, every leaf within relative error
    0.5 and cosine 0.95), then minicpm-2b on the card 6 steps straight
    against 3 steps, ``ckpt.save``, a fresh ``train_loop`` resuming from it
    and 3 more (parameters within 1e-5);
35. adaptive rank at ``benchmarks/bench_adaptive.py``'s shape (8 heads of
    [512, 128] seeded KV-like residuals), ranks 2, 4 and 8 on the card
    against the CPU port: ranks equal, errors within 1e-3; then the paper's
    error table at ``benchmarks/bench_error.py``'s shape (4 heads of [1024,
    128] from the same generator): ``approx_error`` of its ten policies on K
    and on V, ``bench_ablation.py``'s Fig. 4a variants (sparsity 0 / 0.01 /
    0.02 / 0.05 at rank 4, rank 0 / 2 / 4 / 8 at 2%), kivi2's
    ``quant_error``, and ``lowrank_approx`` against ``svd_topr`` on kivi2's
    K residual with its top-8 singular values over the first (Fig. 2b), and
    (no shipped config has them) gear_kcvt4's ``approx_error`` of K at head
    dims 80 and 96 and ``lowrank_approx`` at rank 3, on
    the card against the CPU port: each within 1e-3, each ``size_bytes``
    equal, each card ``approx_error`` call timed; the orderings that
    ``bench_error.py`` asserts are printed, not gated (the data are
    synthetic);
36. training, path 25: rwkv6-3b at its published widths and 32 layers (3.1 B
    parameters), path 23's recipe: the gates of path 23, and exactly 2 x 32
    x 2 ``linear_scan_chunked`` launches a step (the forward and the
    ``dots`` remat's recompute) and 32 x 2 ``linear_scan_chunked_bwd``
    launches, no other kernel; the first live backward call held against
    the plain backward and timed (its launcher run is in phase 40);
37. training, path 26: hymba-1.5b at its published widths and 32 layers, as
    path 25 (its attention trains through ``attention_train``, its SSM
    heads' scans through the kernels);
38. training, path 27: path 23's recipe (minicpm-2b, published widths, 40
    layers, 4 x 512 tokens in 2 microbatches, its ``RunConfig``) through
    ``train_loop(..., steps=3, mesh=make_test_mesh(1, 1))``, ZeRO-1 on, one
    NCCL process: its three losses and grad norms equal to path 23's first
    three, bit for bit, and no kernel launch; the step time beside path
    23's, peak memory, and ``perf.roofline``'s row with ``model_flops`` (6
    N D);
39. training, path 28: PowerSGD on the pod mesh ``make_test_mesh(1, 1,
    pod=1)``, minicpm-2b's smoke config, rank 8, ``powersgd_min_size`` 4096:
    one step on the card against the CPU port from the same weights, batch
    and start matrices (path 24's bounds);
40. the training launcher: ``python -m repro_torch.launch.train --smoke``
    for rwkv6-3b and hymba-1.5b (``--steps 4``) and minicpm-2b's PowerSGD
    mesh (``--steps 2 --mesh 1x1x1 --powersgd --powersgd-min-size 4096``),
    three subprocesses with no ``--device`` started together: each must
    exit 0 and end ``done at step N``, the PowerSGD run with a logged
    ``compressed_bytes`` above 0;
41. summary: one ``{"kernels": [...]}`` JSON line (each kernel's launches
    by path; the backward's on paths 25-26), the card's name and power
    limit, and the final ``{"ok": true, "device": {...}}`` line.

Paths 23, 25, 26 and 27 print ``perf.roofline``'s row for their step: 8 N D
executed operations, AdamW's 28 bytes a parameter, and the measured shares
of the dense bf16 peak at 6 N D (``model_flops``) and at 8 N D.

Kernel times come from ``time_ms``: the median over launches of CUDA
events around one launch with a cold L2, behind a device-side wait that
keeps the host's enqueue time out of the window (device time only).

It imports nothing of JAX and nothing of the JAX package.  Without a CUDA
device, or without the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import gc
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src"

sys.path.insert(0, str(SRC))
try:
    from repro_torch.perf.roofline import HW
except ImportError:              # away from the repository: main() refuses to run
    HW = {"peak_flops": float("nan"), "hbm_bw": float("nan")}
HBM_BYTES_PER_S = HW["hbm_bw"]   # H100 SXM, NVIDIA data sheet (repro_torch.perf.roofline)
BF16_FLOPS = HW["peak_flops"]    # dense bf16 tensor cores (repro_torch.perf.roofline)
F32_FLOPS = 67e12                # f32 outside the tensor cores
TF32_FLOPS = 495e12              # dense TF32 tensor cores

DEV = torch.device("cuda")

DECODE_TOL = 1e-3      # merged decode output, kernel vs plain (f32 both; sum order differs)
PREFILL_TOL = 3e-2     # bf16 output; the kernel rounds P to bf16 before P.V
BLOCK_TOL = 1e-4       # flash_prefill_block normalized output and score max (f32 both)
# gear_compress and quant_pack: bit for bit

B_SERVE, CAP_SERVE, N_REQUESTS, NEW_TOKENS = 4, 1152, 8, 96
# raw prompt lengths of the 8 requests (numpy seed 0), as requests() draws them
PROMPT_LENGTHS = [int(n) for n in np.random.RandomState(0).randint(300, 901, size=N_REQUESTS)]


PHASE_S = {}           # phase header -> seconds from the run's start when it began
_T0 = time.perf_counter()


def phase(header: str) -> None:
    """Print a phase header and note when the phase began."""
    PHASE_S[header.split("]")[0] + "]"] = time.perf_counter() - _T0
    print(header)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


WAIT_MS = 0.5          # least device-side wait ahead of each timed launch
_cycles_per_ms = None


def device_wait(ms: float) -> None:
    """Hold the current stream busy for ~``ms`` on the device
    (``torch.cuda._sleep``, calibrated once against CUDA events)."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        n = 1 << 20
        torch.cuda._sleep(n)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(n)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms = n / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _cycles_per_ms))


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Device time of ``fn`` with a cold L2: the median of ``iters``
    launches, each timed on its own between CUDA events after a write of a
    buffer larger than L2.  A device-side wait after that write, sized to
    outlast the host's enqueue of the start event, ``fn`` and the end event
    (twice ``fn``'s measured host time, at least ``WAIT_MS``), keeps the
    stream busy until all three are queued, so the window holds device time
    only and no host time of the wrapper.  The median drops the rare launch
    whose enqueue the host stalled past the wait (such a window can only
    read long)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wait = max(WAIT_MS, 2.0 * host_ms)
    times = []
    for _ in range(iters):
        flush.zero_()
        device_wait(wait)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_breakdown(fn, iters: int, flush: torch.Tensor) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches, from a
    ``torch.profiler`` window of ``iters`` cold-L2 calls (the flush's fill
    kernels left out): {kernel name: ms}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Fill" not in e.key:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / iters / 1e3
    return out


def timer_check(fn, label: str, flush: torch.Tensor, report: dict) -> None:
    """The timer's own check, once per run: ``time_ms`` of one short call
    beside the kernel time a profiler window reports for it."""
    ev = time_ms(fn, 50, flush)
    kernels = kernel_breakdown(fn, 50, flush)
    prof = sum(kernels.values())
    print(f"  timer check, {label}: CUDA events {ev:.4f} ms, profiler kernel time "
          f"{prof:.4f} ms per call ({kernels})")
    report["timer_check"] = {"what": label, "events_ms": ev, "profiler_ms": prof}


def turns(tree_fn, parent_fn, iters: int, flush: torch.Tensor) -> dict:
    """``time_ms`` of this tree's kernel (c1, c2) and, where a parent tree's
    version is given, of that one (p1, p2), in turns p1, c1, c2, p2 on the
    same operands; c1 alone without a parent."""
    out = {}
    if parent_fn is not None:
        out["p1"] = time_ms(parent_fn, iters, flush)
    out["c1"] = time_ms(tree_fn, iters, flush)
    if parent_fn is not None:
        out["c2"] = time_ms(tree_fn, iters, flush)
        out["p2"] = time_ms(parent_fn, iters, flush)
    return out


def times_text(timed: dict) -> str:
    return ", ".join(f"{key} {val:.4f} ms" for key, val in timed.items())


# ---------------------------------------------------------------------------
# gear_decode


TOKEN_ROWS = ("k_packed", "v_packed", "v_scale", "v_zero", "k_a", "v_a", "v_sp_val", "v_sp_idx")
CHUNK_ROWS = ("k_scale", "k_zero", "k_b", "v_b", "k_sp_val", "k_sp_idx")


def chunk_bytes(operands: dict, chunk: int) -> int:
    """Bytes of one (row, chunk)'s compressed fields."""
    per_chunk = sum(operands[n][0, :chunk].numel() * operands[n].element_size()
                    for n in TOKEN_ROWS if operands.get(n) is not None)
    return per_chunk + sum(operands[n][0, 0].numel() * operands[n].element_size()
                           for n in CHUNK_ROWS if operands.get(n) is not None)


def decode_bytes_flops(operands: dict, n_comp: torch.Tensor, chunk: int):
    """Least bytes and f32 operations of one ``gear_decode`` call: q and
    n_comp read, (acc, m, l) written, and each live (row, chunk)'s
    compressed fields read once, counted from this call's extents."""
    q = operands["q"]
    BH, G, Dh = q.shape
    live = int(((n_comp.long() + chunk - 1) // chunk).clamp(min=0).sum())
    nbytes = (live * chunk_bytes(operands, chunk) + q.numel() * 4 + n_comp.numel() * 4
              + BH * G * (Dh + 2) * 4)
    r = operands["k_a"].shape[-1] if operands.get("k_a") is not None else 0
    flops = live * (4 * chunk * Dh + G * (4 * chunk * Dh + 4 * Dh * r + 4 * chunk * r))
    return nbytes, flops


def pol_half(idx: torch.Tensor) -> int:
    return idx.shape[-1] // 2


def decode_case(policy_name: str, flush, report: dict, H: int = 32, Dh: int = 128,
                G: int = 1, timed: str | None = None) -> None:
    """``gear_decode`` against its plain version on a 4-slot cache of ``H``
    kv heads, ``G`` query rows per row and head_dim ``Dh`` (ragged extents, a
    duplicated outlier index).  With ``timed`` (a key suffix), the kernel,
    the plain version and the call's bound are timed and reported; for
    8 < G <= 16 (the decode regime's 16-row build) the same operands also go
    through the tensor-core history body (``tensor_cores=True``), held
    against the plain version and timed (``ms<suffix>_history``)."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref

    dev = DEV
    B, cap = 4, 1152
    pol = named_policy(policy_name)
    cfg = cache_lib.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=cap, policy=pol)
    gen = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn(B, H, cap, Dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, cap, Dh, generator=gen, device=dev).to(torch.bfloat16)
    k[0, 0, :cfg.chunk, 5] = 3.0        # constant channel: top-k and bottom-k pick one index
    v[0, 0, 10, :] = 2.0                # constant token, likewise on the V side
    cache = cache_lib.prefill_layer_cache(
        cfg, cache_lib.init_layer_cache(cfg, torch.bfloat16, dev), k, v)
    # top-k fill the first half of the outlier slots, bottom-k the second
    dup_k = bool((cache.k_sp_idx[..., 0] == cache.k_sp_idx[..., pol_half(cache.k_sp_idx)]).any())
    dup_v = bool((cache.v_sp_idx[..., 0] == cache.v_sp_idx[..., pol_half(cache.v_sp_idx)]).any())
    if not (dup_k and dup_v):
        fail(f"{policy_name}: the constant-vector fixture stored no duplicate outlier index")
    cache.buf_k.copy_(torch.randn(cache.buf_k.shape, generator=gen, device=dev))
    cache.buf_v.copy_(torch.randn(cache.buf_v.shape, generator=gen, device=dev))
    # ragged slots: empty history, one chunk, mid-cache, full
    cache.length.copy_(torch.tensor([5, 67, 586, cap], dtype=torch.int32, device=dev))
    BH = B * H
    qf = torch.randn(BH, G, Dh, generator=gen, device=dev)
    len_bh = cache.length.repeat_interleave(H)
    n_comp = (len_bh // cfg.chunk * cfg.chunk).to(torch.int32)
    arrays, lr, sp = ops._gear_operands(cfg, cache, BH)
    kw = dict(bits=pol.bits, chunk=cfg.chunk, scale_factor=Dh ** -0.5, **lr, **sp)

    triple_k = gd.gear_decode(qf, *arrays, n_comp, **kw)
    triple_p = gear_decode_ref(qf, *arrays, n_comp, **kw)
    torch.cuda.synchronize()
    out_k = ops._merge_buffer(cfg, cache, qf, *triple_k, len_bh - n_comp, Dh ** -0.5)
    out_p = ops._merge_buffer(cfg, cache, qf, *triple_p, len_bh - n_comp, Dh ** -0.5)
    err = float((out_k - out_p).abs().max())
    print(f"  gear_decode {policy_name} H={H} G={G} Dh={Dh}: merged max_abs_err={err:.3e} "
          f"(tol {DECODE_TOL}) "
          f"n_comp per slot {[int(x) for x in n_comp[::H]]}, duplicate outlier index "
          f"K={dup_k} V={dup_v}")
    if not err <= DECODE_TOL:
        fail(f"gear_decode {policy_name} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)
    if timed is None:
        return
    ms = time_ms(lambda: gd.gear_decode(qf, *arrays, n_comp, **kw), 50, flush)
    plain = time_ms(lambda: gear_decode_ref(qf, *arrays, n_comp, **kw), 5, flush)
    nbytes, flops = decode_bytes_flops(dict(zip(DECODE_NAMES[1:7], arrays), q=qf) | lr | sp,
                                       n_comp, cfg.chunk)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    report.update({f"ms{timed}": ms, f"plain_ms{timed}": plain,
                   f"bound_ms{timed}": max(t_bytes, t_ops),
                   f"bound_by{timed}": "bytes" if t_bytes >= t_ops else "operations"})
    line = (f"    kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({report[f'bound_by{timed}']}, {nbytes / 1e6:.2f} MB)")
    if G > 8:
        triple_h = gd.gear_decode(qf, *arrays, n_comp, tensor_cores=True, **kw)
        out_h = ops._merge_buffer(cfg, cache, qf, *triple_h, len_bh - n_comp, Dh ** -0.5)
        err_h = float((out_h - out_p).abs().max())
        if not err_h <= DECODE_TOL:
            fail(f"gear_decode {policy_name} G={G} through the history body disagrees with "
                 f"its plain version: {err_h}")
        report["err"] = max(report["err"], err_h)
        ms_h = time_ms(lambda: gd.gear_decode(qf, *arrays, n_comp, tensor_cores=True, **kw),
                       50, flush)
        report[f"ms{timed}_history"] = ms_h
        line += (f"; the same operands through the tensor-core history body: max_abs_err="
                 f"{err_h:.3e}, {ms_h:.4f} ms")
    print(line)


# ---------------------------------------------------------------------------
# flash_prefill


FLASH_CASES = [
    # (S, BHq, kv_repeat, window, prefix_len, softcap, head_dim)
    (1024, 32, 1, 0, 0, 0.0, 128),
    (1000, 32, 1, 0, 0, 0.0, 128),
    (1000, 32, 4, 0, 0, 0.0, 128),
    (1000, 32, 1, 256, 0, 30.0, 128),
    (777, 16, 2, 0, 100, 0.0, 128),
    (1000, 25, 5, 0, 0, 0.0, 64),
    (1000, 8, 8, 0, 0, 0.0, 256),
    (1000, 8, 8, 300, 0, 50.0, 256),
    (777, 8, 8, 0, 256, 0.0, 256),
    (1000, 24, 12, 0, 0, 0.0, 128),
    (1000, 64, 16, 0, 0, 0.0, 128),
    (1000, 40, 5, 0, 0, 0.0, 128),
]
# timed cases: S = 1000 lies in the serving paths' prompt range; llama2-7b
# (path 1) reports as "ms", hymba (path 3) as "ms_hymba", gemma-2b (path 12:
# 8 query heads over one KV head of 256) as "ms_gemma", starcoder2-3b (path
# 14: 24 over 2 of 128) as "ms_starcoder2", qwen3-moe (path 20: 64 over 4 of
# 128) as "ms_qwen3", llama4-scout (path 21: 40 over 8 of 128) as "ms_llama4"
TIMED_FLASH_CASES = {1: "", 5: "_hymba", 6: "_gemma", 9: "_starcoder2", 10: "_qwen3",
                     11: "_llama4"}


def flash_pairs(S: int, window: int = 0, prefix: int = 0) -> int:
    """(query, key) pairs one row of ``flash_prefill`` attends: causal, at
    most ``window`` keys back with a window, and the prefix's pairs above
    the diagonal (both positions below ``prefix``)."""
    i = np.arange(S, dtype=np.int64)
    seen = np.minimum(i + 1, window) if window else i + 1
    if prefix:
        seen = np.where(i < prefix, np.maximum(seen, min(prefix, S)), seen)
    return int(seen.sum())


def flash_bytes_flops(S: int, BH: int, rep: int, Dh: int, window: int = 0, prefix: int = 0):
    """Bytes (q, k, v read once, o written once, bf16) and operations of one
    ``flash_prefill`` call over the pairs its mask keeps."""
    return (2.0 * Dh * S * (2 * BH + 2 * BH // rep),
            4.0 * flash_pairs(S, window, prefix) * Dh * BH)


def flash_mask(S: int, window: int, prefix: int):
    """The boolean [S, S] mask (True: attend) of a window and a prefix, as
    ``scaled_dot_product_attention`` takes it; None for the causal mask."""
    if not (window or prefix):
        return None
    i = torch.arange(S, device=DEV)
    ok = i[:, None] >= i[None, :]
    if window:
        ok &= i[:, None] - i[None, :] < window
    if prefix:
        ok |= (i[:, None] < prefix) & (i[None, :] < prefix)
    return ok


def flash_case(case, flush, report: dict, suffix) -> None:
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels.ref import flash_prefill_ref

    S, BH, rep, window, prefix, cap, Dh = case
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(S + rep)
    q = torch.randn(BH, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(BH // rep, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(BH // rep, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(window=window, prefix_len=prefix, softcap=cap, kv_repeat=rep)
    o_k = fp.flash_prefill(q, k, v, **kw)
    o_p = flash_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    line = (f"  flash_prefill S={S} BHq={BH} kv_repeat={rep} Dh={Dh} window={window} "
            f"prefix={prefix} softcap={cap}: max_abs_err={err:.3e} (tol {PREFILL_TOL})")
    if not err <= PREFILL_TOL:
        fail(line)
    report["err"] = max(report.get("err", 0.0), err)
    if suffix is not None:
        ms = time_ms(lambda: fp.flash_prefill(q, k, v, **kw), 20, flush)
        plain = time_ms(lambda: flash_prefill_ref(q, k, v, **kw), 3, flush)
        qs = q[None]
        ks = k[None].repeat_interleave(rep, dim=1)
        vs = v[None].repeat_interleave(rep, dim=1)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20, flush)
        nbytes, flops = flash_bytes_flops(S, BH, rep, Dh)
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        timed = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes")
        report.update({key + suffix: value for key, value in timed.items()})
        line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
                 f"bound {timed['bound_ms']:.4f} ms ({timed['bound_by']})")
    print(line)


# ---------------------------------------------------------------------------
# gear_decode at the streaming history scorer's shape


def history_case(flush, report: dict, H: int = 32, Dh: int = 128, G: int = 1,
                 policy_name: str = "gear_kcvt4", suffix: str = "") -> None:
    """``gear_decode`` as the streaming prefill's history scorer: a batch-1
    cache of ``H`` kv heads (llama2-7b's 32 by default), G * T = 64 G query
    rows per row (the tensor-core regime), one extent n_comp = c * 64 shared
    by all rows; then ``gear_decode_history`` over request 0's 14 in-flight
    blocks in one launch, against its plain version and the per-block calls,
    timed (``ms_history_per_layer_synthetic<suffix>``)."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref, gear_decode_ref

    pol = named_policy(policy_name)
    cfg = cache_lib.CacheConfig(batch=1, kv_heads=H, head_dim=Dh, capacity=CAP_SERVE,
                                policy=pol)
    R = 64 * G
    gen = torch.Generator(device=DEV).manual_seed(2)
    k = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
    cache = cache_lib.prefill_layer_cache(
        cfg, cache_lib.init_layer_cache(cfg, torch.bfloat16, DEV), k, v)
    arrays, lr, sp = ops._gear_operands(cfg, cache, H)
    q = torch.randn(H, R, Dh, generator=gen, device=DEV)
    kw = dict(bits=pol.bits, chunk=cfg.chunk, scale_factor=Dh ** -0.5, **lr, **sp)
    for c in (1, 7, 13):
        acc_k, m_k, l_k = gd.gear_decode(q, *arrays, c * cfg.chunk, **kw)
        acc_p, m_p, l_p = gear_decode_ref(q, *arrays, c * cfg.chunk, **kw)
        torch.cuda.synchronize()
        err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None]).abs().max()),
                  float((m_k - m_p).abs().max()))
        print(f"  gear_decode {policy_name} H={H} Dh={Dh} G*T={R}, n_comp={c * cfg.chunk}: "
              f"max_abs_err={err:.3e} (tol {DECODE_TOL})")
        if not err <= DECODE_TOL:
            fail(f"gear_decode at {R} query rows disagrees with its plain version: {err}")
        report["err"] = max(report.get("err", 0.0), err)

    # request 0's layer-0 history work in one launch: its 859 tokens bucket
    # to 14 blocks of 64 query rows; block i sees the i * 64 tokens before it
    n_blocks = -(-PROMPT_LENGTHS[0] // cfg.chunk)
    extents = [i * cfg.chunk for i in range(n_blocks)]
    qb = torch.randn(H, n_blocks, R, Dh, generator=gen, device=DEV)
    gd.gear_decode.launches = 0
    acc_k, m_k, l_k = gd.gear_decode_history(qb, *arrays, extents, **kw)
    launches = gd.gear_decode.launches
    acc_p, m_p, l_p = gear_decode_history_ref(qb, *arrays, extents, **kw)
    per_block = [gd.gear_decode(qb[:, i].contiguous(), *arrays, e, **kw)
                 for i, e in enumerate(extents)]
    torch.cuda.synchronize()
    live = slice(1, None)                                     # block 0 has no history
    err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None])[:, live].abs().max()),
              float((m_k - m_p)[:, live].abs().max()))
    bitwise = all(torch.equal(a[:, i], b) for i, one in enumerate(per_block)
                  for a, b in zip((acc_k, m_k, l_k), one))
    ms = time_ms(lambda: gd.gear_decode_history(qb, *arrays, extents, **kw), 20, flush)
    plain = time_ms(lambda: gear_decode_history_ref(qb, *arrays, extents, **kw), 3, flush)
    nbytes, flops = history_bytes_flops(qb, dict(zip(DECODE_NAMES[1:7], arrays)) | lr | sp,
                                        extents, cfg.chunk)
    print(f"  gear_decode_history {policy_name} (H={H}, Dh={Dh}, {pol_groups(arrays)} V stat "
          f"groups), request 0's layer-0 shape ({n_blocks} blocks x {R} query rows, "
          f"extents 0..{extents[-1]}): {launches} launch, max_abs_err={err:.3e} (tol "
          f"{DECODE_TOL}), equal to {n_blocks} per-block gear_decode calls bit for bit = "
          f"{bitwise} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3:.4f} ms")
    if launches != 1 or not err <= DECODE_TOL or not bitwise:
        fail("gear_decode_history disagrees with its plain version or its per-block calls")
    report["err"] = max(report.get("err", 0.0), err)
    report["ms_history_per_layer_synthetic" + suffix] = ms


def pol_groups(arrays) -> int:
    """V stat groups of a cache's operands (the last dim of ``v_scale``)."""
    return int(arrays[4].shape[-1])


def history_bytes_flops(q, operands: dict, extents, chunk: int):
    """Least bytes and operations of one ``gear_decode_history`` call: q
    read and (acc, m, l) written once, each row's chunks up to the largest
    extent read once; 4 Dh (+ low-rank) operations per (query row, live
    token) of every block.  The operations are counted at the bf16
    tensor-core rate, the rate of the products the kernel runs."""
    BH, NB, R, Dh = q.shape
    ext = [int(e) for e in extents]
    live = -(-max(ext) // chunk)
    r = operands["k_a"].shape[-1] if operands.get("k_a") is not None else 0
    nbytes = BH * live * chunk_bytes(operands, chunk) + q.numel() * 4 + BH * NB * R * (Dh + 2) * 4
    tokens = sum(-(-e // chunk) * chunk for e in ext)
    flops = BH * R * tokens * (4 * Dh + 4 * r) + BH * R * sum(-(-e // chunk) for e in ext) * 4 * Dh * r
    return nbytes, flops


def history_call_bytes_flops(args, kwargs):
    operands = dict(zip(DECODE_NAMES[1:7], args[1:7])) | {
        k: v for k, v in kwargs.items() if isinstance(v, torch.Tensor)}
    return history_bytes_flops(args[0], operands, args[7], kwargs["chunk"])


# ---------------------------------------------------------------------------
# gear_compress


COMPRESS_OUTPUTS = ("packed", "scale", "zero", "sp_val", "sp_idx", "resid")


def compress_check(x, kw, label: str, report: dict) -> None:
    """Kernel vs plain version on ``x``: every output bit for bit, and two
    calls of the kernel bitwise equal."""
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels.ref import gear_compress_ref

    got = gc.gear_compress(x, **kw)
    again = gc.gear_compress(x, **kw)
    want = gear_compress_ref(x, **kw)
    torch.cuda.synchronize()
    differ, unstable = {}, []
    for name, a, b, w in zip(COMPRESS_OUTPUTS, got, again, want):
        if a is None or w is None:
            if (a is None) != (w is None):
                differ[name] = "missing"
            continue
        if not torch.equal(a, b):
            unstable.append(name)
        w = w.to(a.dtype)
        if not torch.equal(a, w):
            differ[name] = int((a != w).sum())
    resid_err = float((got[5] - want[5]).abs().max())
    print(f"  gear_compress {label}: equal to the plain version bit for bit = {not differ}"
          + (f" (entries that differ: {differ})" if differ else "")
          + f", two calls bitwise equal = {not unstable}")
    if differ or unstable:
        fail(f"gear_compress {label} differs from its plain version {differ} or across two "
             f"calls {unstable}")
    report["err"] = max(report.get("err", 0.0), resid_err)


def compress_time(x, kw, label: str, flush, report: dict) -> dict:
    """The kernel (with ``--parent-kernels``, the parent's in turns), its
    plain version and the call's bound; the row is appended to the report's
    cases and returned."""
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels.ref import gear_compress_ref

    parent = PARENT_KERNELS.get("gear_compress")
    timed = turns(lambda: gc.gear_compress(x, **kw),
                  None if parent is None else lambda: parent(x, **kw), 50, flush)
    plain = time_ms(lambda: gear_compress_ref(x, **kw), 5, flush)
    nbytes, flops = compress_bytes_flops(x, kw)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    row = {"what": label, **{f"ms_{key}": val for key, val in timed.items()}, "plain_ms": plain,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"    {label}: kernel {times_text(timed)}, plain {plain:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {nbytes / 1e6:.2f} MB)")
    report.setdefault("cases", []).append(row)
    return row


def compress_kwargs(pol, kind: str, nb: int, d: int) -> dict:
    from repro_torch.core.outlier import outlier_count

    scheme, group = pol.scheme_for(kind)
    vec = nb if scheme == "per_channel" else d
    n_out = outlier_count(vec, pol.sparsity) if pol.use_sparse else 0
    return dict(bits=pol.bits, scheme=scheme, group=group, n_out=n_out,
                stat_dtype=pol.stat_dtype)


def compress_case(policy_name: str, flush, report: dict) -> None:
    """Both orientations over 448 [64, 128] tiles (32 kv heads x 14 chunks),
    with a constant channel and a constant token (top and bottom outliers
    share an index), each timed."""
    from repro_torch.core.policy import named_policy

    pol = named_policy(policy_name)
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn(448, 64, 128, generator=gen, device=DEV).to(torch.bfloat16).float()
    x[0, :, 5] = 1.25
    x[1, 9, :] = -0.75
    for kind in ("k", "v"):
        kw = compress_kwargs(pol, kind, 64, 128)
        label = (f"{policy_name} {kind.upper()} ({kw['scheme']}, group {kw['group']}, "
                 f"{kw['n_out']} outliers per extreme)")
        compress_check(x, kw, label, report)
        compress_time(x, kw, label, flush, report)
        if policy_name == "gear_kcvt4" and kind == "k":
            compress_probes(x, kw, flush, report)
        compress_nan_check(kw, label)


def compress_nan_check(kw: dict, label: str) -> None:
    """A K channel (V token) with more NaNs than its outlier count, one with
    a single NaN, and an all-NaN tile: every output equal to the plain
    version's, a NaN equal to any NaN, and NaN stats in those tiles.  With
    ``--parent-kernels`` the parent's kernel is held on the same input and
    reported, not failed."""
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels.ref import gear_compress_ref

    x = torch.randn(448, 64, 128, generator=torch.Generator(device=DEV).manual_seed(4),
                    device=DEV).to(torch.bfloat16).float()
    many = torch.arange(2 * kw["n_out"] + 1, device=DEV) * 5
    if kw["scheme"] == "per_channel":
        x[0, many, 7] = float("nan")
        x[1, 30, 9] = float("nan")
    else:
        x[0, 7, many] = float("nan")
        x[1, 30, 100] = float("nan")
    x[2] = float("nan")
    want = gear_compress_ref(x, **kw)

    def equal(got) -> dict:
        return {name: nan_equal(a, w.to(a.dtype)) for name, a, w in
                zip(COMPRESS_OUTPUTS, got, want) if a is not None and w is not None}

    got = gc.gear_compress(x, **kw)
    same = equal(got)
    nan_stats = bool(torch.isnan(got[1][0]).any()) and bool(torch.isnan(got[1][2]).all())
    print(f"    NaN tiles ({2 * kw['n_out'] + 1} NaNs in one vector, 1 in another, an all-NaN "
          f"tile): equal to the plain version = {same}, NaN stats = {nan_stats}")
    if not (all(same.values()) and nan_stats):
        fail(f"gear_compress {label} on NaN tiles differs from its plain version {same}")
    parent = PARENT_KERNELS.get("gear_compress")
    if parent is not None:
        print(f"    parent's kernel on the NaN tiles: equal = {equal(parent(x, **kw))}")


def compress_probes(x, kw, flush, report: dict) -> None:
    """What bounds the event, probed on the same tiles: the kernel without
    its outlier search (n_out = 0), and a device copy of the bytes it reads
    and writes most of (x into a residual-sized buffer), which no kernel
    that reads and writes those bytes can beat."""
    from repro_torch.kernels import gear_compress as gc

    resid = torch.empty_like(x)
    probes = {"no_outliers_ms": time_ms(lambda: gc.gear_compress(x, **{**kw, "n_out": 0}), 50,
                                        flush),
              "copy_ms": time_ms(lambda: resid.copy_(x), 50, flush)}
    print(f"    probes: the kernel without outliers {probes['no_outliers_ms']:.4f} ms; a device "
          f"copy of x ({x.numel() * 8 / 1e6:.2f} MB read and written) {probes['copy_ms']:.4f} ms")
    report["probes"] = probes


def compress_bytes_flops(x: torch.Tensor, kw: dict):
    """Least bytes and f32 operations of one ``gear_compress`` call: x read
    once; packed codes, stats, outliers and the residual written once; per
    element, 2 compares per outlier sweep of each extreme, the group
    min/max, and the quantize / dequantize / residual arithmetic (~10)."""
    N, nb, d = x.shape
    per = 32 // kw["bits"]
    group = kw["group"] or (nb if kw["scheme"] == "per_channel" else d)
    n_stat = (nb // group) * d if kw["scheme"] == "per_channel" else nb * (d // group)
    sp_rows = d if kw["scheme"] == "per_channel" else nb
    out = N * (nb * d // per + 2 * n_stat + 2 * sp_rows * 2 * kw["n_out"] + nb * d) * 4
    nbytes = x.numel() * 4 + out
    flops = x.numel() * (2 * 2 * kw["n_out"] + 2 + 10)
    return nbytes, flops


# ---------------------------------------------------------------------------
# flash_prefill_block


def block_bytes_flops(q, k, kv_len):
    """Least bytes and f32 operations of one ``flash_prefill_block`` call:
    q, k, v and kv_len read once, (acc, m, l) written once; 4 Dh operations
    (q.k and p.v) per visible (query, key) pair of this call's masks."""
    N, T, Dh = q.shape
    t = torch.arange(T, device=q.device)
    pairs = int(torch.minimum(t[None, :] + 1, kv_len.long()[:, None]).sum())
    nbytes = (q.numel() + 2 * k.numel() + N * T * (Dh + 2) + N) * 4
    return nbytes, 4 * Dh * pairs


def block_library(args, kwargs, flush) -> dict:
    """The library yardstick of a ``flash_prefill_block`` call:
    ``torch.ops.aten._scaled_dot_product_efficient_attention`` on the same
    f32 operands (K/V repeated for GQA and the causal and kv_len mask built
    as an additive bias, both outside the timed window; the call reads the
    bias, N T^2 f32, besides q, k and v), returning (out, lse) = (acc / l,
    m + log l).  It is held against the plain version within BLOCK_TOL
    first; where the op refuses the operands or disagrees, its error is
    returned instead of a time.  The port never calls it."""
    from repro_torch.kernels.ref import flash_block_ref

    q, k, v, kv_len = args[:4]
    scale, rep = kwargs["scale"], kwargs.get("kv_repeat", 1)
    N, T, _ = q.shape
    note = ("reads an additive [N, 1, T, T] f32 mask bias "
            f"({N * T * T * 4 / 1e6:.2f} MB) besides q, k and v")
    try:
        kx = k.repeat_interleave(rep, dim=0)[:, None]
        vx = v.repeat_interleave(rep, dim=0)[:, None]
        t = torch.arange(T, device=q.device)
        ok = (t[None, :] <= t[:, None])[None] & (t[None, None, :] < kv_len.long()[:, None, None])
        bias = torch.zeros(N, 1, T, -(-T // 16) * 16, device=q.device)   # 16-aligned rows
        bias[..., :T].masked_fill_(~ok[:, None], float("-inf"))
        bias = bias[..., :T]
        qx = q[:, None]

        def call():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qx, kx, vx, bias, True, scale=scale)

        out, lse = call()[:2]
        acc_p, m_p, l_p = flash_block_ref(*args, **kwargs)
        torch.cuda.synchronize()
        err = max(float((out[:, 0] - acc_p / l_p[..., None]).abs().max()),
                  float((lse[:, 0, :T] - (m_p + torch.log(l_p))).abs().max()))
        if not err <= BLOCK_TOL:
            return {"library_ms": None, "library_note": f"efficient attention disagrees with "
                    f"the plain version: max_abs_err {err:.3e} > {BLOCK_TOL}"}
        return {"library_ms": time_ms(call, 50, flush), "library_err": err, "library_note": note}
    except (RuntimeError, TypeError, ValueError) as exc:   # its error is the finding
        return {"library_ms": None, "library_note": f"{type(exc).__name__}: {exc}"[:400]}


def block_check(fn, args, kwargs, label: str, flush, report: dict, library: bool) -> dict:
    """Kernel vs plain version (normalized output and score max within
    BLOCK_TOL), two calls bitwise equal; then the kernel's times (with
    ``--parent-kernels``, the parent's in turns), the plain version's, the
    call's bound and, with ``library``, the efficient-attention yardstick."""
    from repro_torch.kernels.ref import flash_block_ref

    acc_k, m_k, l_k = fn(*args, **kwargs)
    again = fn(*args, **kwargs)
    acc_p, m_p, l_p = flash_block_ref(*args, **kwargs)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip((acc_k, m_k, l_k), again))
    err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None]).abs().max()),
              float((m_k - m_p).abs().max()))
    print(f"  {label}: max_abs_err={err:.3e} (tol {BLOCK_TOL}), two calls bitwise equal: "
          f"{bitwise}")
    if not (err <= BLOCK_TOL and bitwise):
        fail(f"{label} disagrees with its plain version ({err}) or across two calls")
    report["err"] = max(report.get("err", 0.0), err)
    parent = PARENT_KERNELS.get("flash_prefill_block")
    timed = turns(lambda: fn(*args, **kwargs),
                  None if parent is None else lambda: parent(*args, **kwargs), 50, flush)
    plain = time_ms(lambda: flash_block_ref(*args, **kwargs), 5, flush)
    nbytes, flops = block_bytes_flops(args[0], args[1], args[3])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    row = {"what": label, **{f"ms_{key}": val for key, val in timed.items()}, "plain_ms": plain,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if library:
        row.update(block_library(args, kwargs, flush))
    lib = ""
    if library:
        lib = (f", efficient attention {row['library_ms']:.4f} ms ({row['library_note']})"
               if row["library_ms"] is not None else f", efficient attention: {row['library_note']}")
    print(f"    kernel {times_text(timed)}, plain {plain:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {nbytes / 1e6:.2f} MB; {flops / 1e9:.3f} GFLOP of visible pairs)"
          + lib)
    report.setdefault("cases", []).append(row)
    return row


def block_case(T: int, rep: int, flush, report: dict) -> None:
    from repro_torch.kernels import flash_prefill as fp

    N, Dh = 448, 128
    gen = torch.Generator(device=DEV).manual_seed(T + rep)
    q = torch.randn(N, T, Dh, generator=gen, device=DEV)
    k = torch.randn(N // rep, T, Dh, generator=gen, device=DEV)
    v = torch.randn(N // rep, T, Dh, generator=gen, device=DEV)
    kv_len = (torch.full((N,), T, dtype=torch.int32, device=DEV) if T == 64 else
              torch.randint(1, T + 1, (N,), generator=gen, device=DEV, dtype=torch.int32))
    kw = dict(scale=Dh ** -0.5, kv_repeat=rep)
    block_check(fp.flash_prefill_block, (q, k, v, kv_len), kw,
                f"flash_prefill_block N={N} T={T} kv_repeat={rep} kv_len "
                f"{'= T' if T == 64 else 'random in [1, T]'}", flush, report,
                library=T == 64 and rep == 1)
    if T == 64 and rep == 1:
        # the wave structure: three blocks (row groups) fit an SM at Dh 128
        wave = 3 * torch.cuda.get_device_properties(0).multi_processor_count
        one = time_ms(lambda: fp.flash_prefill_block(q[:wave], k[:wave], v[:wave],
                                                     kv_len[:wave], **kw), 50, flush)
        alone = time_ms(lambda: fp.flash_prefill_block(q[:1], k[:1], v[:1], kv_len[:1], **kw),
                        50, flush)
        print(f"    probes: one full wave ({wave} row groups, 3 per SM) {one:.4f} ms; "
              f"one row group alone {alone:.4f} ms")
        report["probes"] = {"one_wave_rows": wave, "one_wave_ms": one, "one_block_ms": alone}


# ---------------------------------------------------------------------------
# gear_decode_paged


def paged_case(policy_name: str, report: dict, H: int = 32, Dh: int = 128, G: int = 1) -> None:
    """A 4-slot cache of the main path's shapes (or of ``H`` kv heads of
    ``Dh`` with ``G`` query rows each) scattered into a shuffled pool; table
    entries past each slot's extent name the zero page.  The paged kernel
    must equal ``gear_decode`` on the gathered operands bit for bit and its
    plain version within DECODE_TOL."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gather_paged_operands, gear_decode_paged_ref

    B = B_SERVE
    pol = named_policy(policy_name)
    cfg = cache_lib.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=CAP_SERVE, policy=pol)
    cfg1 = cache_lib.CacheConfig(batch=1, kv_heads=H, head_dim=Dh, capacity=CAP_SERVE, policy=pol)
    nb, C = cfg.chunk, cfg.n_chunks
    gen = torch.Generator(device=DEV).manual_seed(4)
    lengths = [5, 67, 586, CAP_SERVE]
    live = [n // nb for n in lengths]
    n_pages = 1 + sum(live)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(0)) + 1
    pool = cache_lib.init_paged_layer_cache(cfg, n_pages, torch.bfloat16, DEV)
    bt = torch.zeros((B, C), dtype=torch.int32)
    used = 0
    for b in range(B):
        k = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
        v = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
        one = cache_lib.prefill_layer_cache(
            cfg1, cache_lib.init_layer_cache(cfg1, torch.bfloat16, DEV), k, v)
        pages = perm[used:used + live[b]]
        used += live[b]
        bt[b, :live[b]] = pages
        cache_lib.scatter_pool_chunks(cfg1, pool, pages.to(DEV),
                                      cache_lib.extract_prefix_chunks(cfg1, one, live[b]))
    bt = bt.to(DEV)
    BH = B * H
    n_comp = torch.tensor(lengths, dtype=torch.int32, device=DEV).repeat_interleave(H) // nb * nb
    q = torch.randn(BH, G, Dh, generator=gen, device=DEV)
    arrays, lr, sp = ops._paged_operands(cfg, pool)
    kw = dict(bits=pol.bits, chunk=nb, scale_factor=Dh ** -0.5)
    paged = gd.gear_decode_paged(q, *arrays, n_comp, bt, **kw, **lr, **sp)
    plain = gear_decode_paged_ref(q, *arrays, n_comp, bt, **kw, **lr, **sp)
    names = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")
    g = gather_paged_operands(bt, BH, dict(zip(names, arrays)) | lr | sp)
    flat = gd.gear_decode(q, *[g[n] for n in names], n_comp, **kw,
                          **{n: g[n] for n in list(lr) + list(sp)})
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(paged, flat))
    rows = n_comp > 0
    err = max(float((paged[0] / paged[2][..., None] - plain[0] / plain[2][..., None])[rows]
                    .abs().max()), float((paged[1] - plain[1])[rows].abs().max()))
    print(f"  gear_decode_paged {policy_name} H={H} Dh={Dh} G={G}: {n_pages} pages, n_comp per slot "
          f"{[int(x) for x in n_comp[::H]]}: bitwise equal to gear_decode on gathered operands "
          f"= {bitwise}; vs plain max_abs_err={err:.3e} (tol {DECODE_TOL})")
    if not bitwise:
        fail(f"gear_decode_paged {policy_name} differs from gear_decode on gathered operands")
    if not err <= DECODE_TOL:
        fail(f"gear_decode_paged {policy_name} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)


# ---------------------------------------------------------------------------
# linear_scan_chunked


SCAN_CASES = [
    # (mode, BH, S, Dk, Dv, log_w columns, chunk, initial state)
    ("inclusive", 25, 1024, 16, 64, 1, 64, False),   # hymba heads, aligned: 16 chunks
    ("inclusive", 25, 859, 16, 64, 1, 859, False),   # hymba's live shape: chunk = S
    ("inclusive", 4, 200, 16, 64, 16, 200, False),   # per-Dk decay, chunk = S
    ("bonus", 40, 1024, 64, 64, 64, 64, False),      # RWKV6-3b's heads, u nonzero
    ("bonus", 40, 859, 64, 64, 64, 859, False),      # RWKV6-3b's live prefill: chunk = S
    ("bonus", 160, 1, 64, 64, 64, 1, True),          # RWKV6-3b's decode step, 4 slots
]


PARENT_SCAN = None     # the parent tree's kernel, set by --parent-scan
PARENT_SCAN_BWD = None  # its backward, where the parent's library exports one
PARENT_KERNELS = {}    # kernel name -> the parent tree's version, set by --parent-kernels
# kernels --parent-kernels builds: (wrapper module, its launcher, the C entry point)
PARENT_SOURCES = {"flash_prefill_block": ("flash_prefill", "_block_launcher", "flash_block_launch"),
                  "gear_compress": ("gear_compress", "_launcher", "gear_compress_launch"),
                  "quant_pack": ("quant_pack", "_launcher", "quant_pack_launch")}


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel in an anonymous namespace
    (bool, int, float and bf16 arguments); the mangled name otherwise."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + len(name):]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"Lb([01])E|Li(-?\d+)E|(13__nv_bfloat16)|^I(f)E", rest[:rest.find("Ev") + 1])
    words = [("true" if b == "1" else "false") if b else i or ("bf16" if h else "float")
             for b, i, h, f in args]
    return f"{name}<{', '.join(words)}>"


def ptxas_summary(log: str) -> str:
    """Each entry function's registers and spilled bytes from an ``nvcc
    -Xptxas -v`` log, as "kernel<args> R regs[, S B spilled]"."""
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = kernel_name(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{fn} {m.group(1)} regs" + (f", {spill} B spilled" if spill else ""))
            fn = None
    return "; ".join(out)


def start_parent_build(src: pathlib.Path):
    """Start ``nvcc`` on a parent tree's ``<name>.cu`` beside this tree's
    build; returns (process, library path).  A header the parent's
    directory lacks comes from this tree's ``csrc/`` (``-I``)."""
    from repro_torch.kernels import _build

    out = _build.BUILD / "parent" / f"lib{src.stem}_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def parent_kernel(name: str, proc, lib_path: pathlib.Path):
    """A parent tree's kernel ``name`` as a function of its wrapper's
    signature: this tree's wrapper checks the operands and allocates the
    outputs, the parent's library launches (its C entry point takes the same
    arguments); it counts nothing."""
    import ctypes
    import importlib

    mod_name, attr, entry = PARENT_SOURCES[name]
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"the parent's {name}.cu did not build:\n{log}")
    module = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    wrapper = getattr(module, name)
    tree = getattr(module, attr)()
    launch = getattr(ctypes.CDLL(str(lib_path)), entry)
    launch.argtypes, launch.restype = tree.argtypes, tree.restype

    def call(*args, **kwargs):
        real, launches = getattr(module, attr), wrapper.launches
        setattr(module, attr, lambda: launch)
        try:
            return wrapper(*args, **kwargs)
        finally:
            setattr(module, attr, real)
            wrapper.launches = launches

    print(f"  parent {name}.cu built; {ptxas_summary(log)}")
    return call


def parent_scan(proc, lib_path: pathlib.Path):
    """The parent's kernel as a function of ``linear_scan_chunked``'s
    signature (operands as the wrapper checks them; it counts nothing).  A
    library that exports ``linear_scan_workspace_bytes`` takes a workspace
    after the state pointer; an older one takes none.  Returns (forward,
    backward): the backward, of ``linear_scan_chunked_bwd``'s signature, is
    None unless the library exports ``linear_scan_bwd_launch`` and
    ``linear_scan_bwd_workspace_bytes``."""
    import ctypes

    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"the parent's linear_scan.cu did not build:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    ws_bytes = getattr(lib, "linear_scan_workspace_bytes", None)
    launch = lib.linear_scan_launch
    launch.argtypes = ([ctypes.c_void_p] * (8 if ws_bytes is None else 9) + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    if ws_bytes is not None:
        ws_bytes.argtypes = [ctypes.c_int] * 5
        ws_bytes.restype = ctypes.c_longlong

    def call(r, k, v, log_w, u=None, *, chunk, mode, state0=None):
        BH, S, Dk = r.shape
        Dv = v.shape[-1]
        y = torch.empty_like(v)
        state = torch.empty((BH, Dk, Dv), dtype=torch.float32, device=r.device)
        ws = []
        if ws_bytes is not None:
            n = ws_bytes(BH, S, Dk, Dv, chunk)
            buf = torch.empty(n, dtype=torch.uint8, device=r.device) if n else None
            ws = [None if buf is None else buf.data_ptr()]
        code = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                      None if u is None else u.data_ptr(),
                      None if state0 is None else state0.data_ptr(), y.data_ptr(),
                      state.data_ptr(), *ws, BH, S, Dk, Dv, log_w.shape[-1], chunk,
                      int(mode == "bonus"), torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"the parent's linear_scan kernel: CUDA error {code}")
        return y, state

    bwd_launch = getattr(lib, "linear_scan_bwd_launch", None)
    bwd_ws = getattr(lib, "linear_scan_bwd_workspace_bytes", None)
    call_bwd = None
    if bwd_launch is not None and bwd_ws is not None:
        bwd_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        bwd_launch.restype = ctypes.c_int
        bwd_ws.argtypes = [ctypes.c_int] * 6
        bwd_ws.restype = ctypes.c_longlong

        def call_bwd(r, k, v, log_w, u=None, *, chunk, mode, state0=None, dy, dstate=None):
            def ptr(x):
                return None if x is None else x.data_ptr()

            BH, S, Dk = r.shape
            Dv = v.shape[-1]
            dr, dk, dv, dlw = (torch.empty_like(x) for x in (r, k, v, log_w))
            du = torch.empty_like(u) if mode == "bonus" else None
            ds0 = None if state0 is None else torch.empty_like(state0)
            n = bwd_ws(BH, S, Dk, Dv, log_w.shape[-1], chunk)
            buf = torch.empty(max(n, 16), dtype=torch.uint8, device=r.device)
            code = bwd_launch(ptr(r), ptr(k), ptr(v), ptr(log_w), ptr(u), ptr(state0), ptr(dy),
                              ptr(dstate), ptr(dr), ptr(dk), ptr(dv), ptr(dlw), ptr(du), ptr(ds0),
                              ptr(buf), BH, S, Dk, Dv, log_w.shape[-1], chunk,
                              int(mode == "bonus"), torch.cuda.current_stream().cuda_stream)
            if code:
                fail(f"the parent's linear_scan backward: CUDA error {code}")
            return dr, dk, dv, dlw, du, ds0

    print(f"  parent linear_scan.cu built ({'with' if call_bwd else 'without'} a backward); "
          f"{ptxas_summary(log)}")
    return call, call_bwd


def scan_inputs(mode, BH, S, Dk, Dv, lw_cols, seed: int):
    """Hymba-like inputs: one decay per head near the reference's init
    (-softplus(x - 1), x ~ N(0, 0.5^2)); RWKV-like: per-Dk log w = -exp(x)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r = torch.randn(BH, S, Dk, generator=gen, device=DEV)
    k = torch.randn(BH, S, Dk, generator=gen, device=DEV)
    v = torch.randn(BH, S, Dv, generator=gen, device=DEV)
    x = torch.randn(BH, S, lw_cols, generator=gen, device=DEV) * 0.5
    lw = (-torch.exp(x - 2.0) if mode == "bonus"
          else -torch.nn.functional.softplus(x - 1.0))
    u = torch.randn(BH, Dk, generator=gen, device=DEV) * 0.5 if mode == "bonus" else None
    return r, k, v, lw, u


def scan_bytes_flops(r, k, v, lw, u, chunk: int, mode: str, state0=None):
    """Least bytes and f32 operations of one ``linear_scan_chunked`` call:
    r, k, v, log w (and u, and the initial state) read once, y and the final
    state written once.  Per chunk of W tokens: 2 (Dk + Dv) operations per
    visible (query, key) pair of the causal intra product (W (W + 1) / 2
    pairs, or W (W - 1) / 2 for ``bonus``) and 2 Dk Dv per token for the
    state update; per token, the cumsum and 3 exponentials per log w column
    and 3 Dk factor products, and the bonus term.  From a zero state the
    cross-chunk read (2 Dk Dv per token) and the state's decay (Dk Dv) do
    work only in the chunks after the first; from an initial state, in
    every chunk.  Returns (bytes, operations, the operations of these that
    the kernel runs on the tensor cores): at chunk > 1 the intra products,
    the state increments and the cross terms."""
    BH, S, Dk = r.shape
    Dv, L = v.shape[-1], lw.shape[-1]
    W = chunk
    n = S // W
    pairs = W * (W + 1) // 2 if mode == "inclusive" else W * (W - 1) // 2
    per_chunk = pairs * 2 * (Dk + Dv) + W * (2 * Dk * Dv + 4 * L + 3 * Dk)
    if mode == "bonus":
        per_chunk += W * (3 * Dk + 2 * Dv)
    cross = W * 2 * Dk * Dv + Dk * Dv
    flops = BH * (n * per_chunk + (n if state0 is not None else n - 1) * cross)
    mma = 0
    if W > 1:
        mma = BH * (n * (pairs * 2 * (Dk + Dv) + W * 2 * Dk * Dv)
                    + (n if state0 is not None else n - 1) * W * 2 * Dk * Dv)
    inputs = r.numel() + k.numel() + v.numel() + lw.numel() + (0 if u is None else u.numel())
    inputs += 0 if state0 is None else state0.numel()
    nbytes = 4 * (inputs + BH * S * Dv + BH * Dk * Dv)
    return nbytes, flops, mma


def row_err(got: torch.Tensor, want: torch.Tensor):
    """Largest error over the rows of the last dim, each against 2e-3 x max(1,
    max |want| of that row): (worst ratio err / limit, median |want|)."""
    limit = 2e-3 * want.abs().amax(-1).clamp_min(1.0)
    ratio = float(((got - want).abs().amax(-1) / limit).max())
    return ratio, float(want.abs().median())


def scan_check(fn, args: tuple, kw: dict, label: str, flush, report: dict, iters: int = 20,
               list_kernels: bool = False):
    """Kernel vs plain version (y and final state) within 2e-3 x max(1,
    max |plain|), and within 2e-3 x max(1, max |plain| of the row) for every
    row (token of y, Dk row of the state), so a wrong ordinary-sized entry
    fails even where the clamp has blown a few late rows up; two calls
    equal bit for bit.  Then the times (with ``--parent-scan``, the parent
    tree's kernel in turns p1, c1, c2, p2 on the same operands), with
    ``list_kernels`` the CUDA kernels one call launches and their device
    times (a profiler window),
    and the call's bounds: f32 operations at the
    SIMT rate, and with the tensor-core products at the TF32 rate, three
    passes each.  Returns (ms, plain_ms, bound_ms, bound_by)."""
    from repro_torch.kernels.ref import linear_scan_ref

    y_k, st_k = fn(*args, **kw)
    y_k2, st_k2 = fn(*args, **kw)
    y_p, st_p = linear_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    bitwise = torch.equal(y_k, y_k2) and torch.equal(st_k, st_k2)
    scale_y = max(1.0, float(y_p.abs().max()))
    scale_s = max(1.0, float(st_p.abs().max()))
    err_y = float((y_k - y_p).abs().max())
    err_s = float((st_k - st_p).abs().max())
    row_y, med_y = row_err(y_k, y_p)
    row_s, med_s = row_err(st_k, st_p)
    ok = (err_y <= 2e-3 * scale_y and err_s <= 2e-3 * scale_s
          and row_y <= 1.0 and row_s <= 1.0 and bitwise)
    timed = turns(lambda: fn(*args, **kw),
                  None if PARENT_SCAN is None else lambda: PARENT_SCAN(*args, **kw), iters, flush)
    ms = timed["c1"]
    plain_ms = time_ms(lambda: linear_scan_ref(*args, **kw), 3, flush)
    names = kernel_breakdown(lambda: fn(*args, **kw), 10, flush) if list_kernels else None
    nbytes, flops, mma = scan_bytes_flops(*args, kw["chunk"], kw["mode"], kw.get("state0"))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    t_tc = max(t_bytes, (3 * mma / TF32_FLOPS + (flops - mma) / F32_FLOPS) * 1e3)
    times = times_text(timed)
    print(f"  {label}: y max_abs_err={err_y:.3e} (tol 2e-3 x {scale_y:.3g}; median |y| "
          f"{med_y:.3g}; worst row at {row_y:.3g} of its limit), state max_abs_err="
          f"{err_s:.3e} (tol 2e-3 x {scale_s:.3g}; median {med_s:.3g}; worst row at "
          f"{row_s:.3g} of its limit), two calls bitwise equal: {bitwise}")
    print(f"    kernel {times}, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at f32 {F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s)" + (f"; with its {mma / 1e9:.3f} GFLOP of products on the TF32 tensor "
                         f"cores ({TF32_FLOPS / 1e12:.0f} TFLOP/s, 3 passes) {t_tc:.4f} ms"
                         if mma else "") + ("; CUDA kernels per call (ms): " + ", ".join(
                             f"{key} {val:.4f}" for key, val in names.items()) if names else ""))
    if not ok:
        fail(f"{label} disagrees with its plain version")
    report["err"] = max(report.get("err", 0.0), err_y, err_s)
    report["err_over_scale"] = max(report.get("err_over_scale", 0.0), err_y / scale_y,
                                   err_s / scale_s)
    report.setdefault("cases", []).append(
        {"what": label, **{f"ms_{key}": val for key, val in timed.items()}, "plain_ms": plain_ms,
         "bound_ms": bound, "bound_by": by, "bound_ms_tf32x3": t_tc if mma else None}
        | ({"kernels": names} if names else {}))
    return ms, plain_ms, bound, by


def scan_case(case, flush, report: dict) -> None:
    from repro_torch.kernels import linear_scan_kernel as lsk

    mode, BH, S, Dk, Dv, lw_cols, chunk, with_state = case
    r, k, v, lw, u = scan_inputs(mode, BH, S, Dk, Dv, lw_cols, S + Dk)
    kw = dict(chunk=chunk, mode=mode)
    if with_state:
        kw["state0"] = torch.randn(BH, Dk, Dv, generator=torch.Generator(device=DEV).manual_seed(S),
                                   device=DEV)
    scan_check(lsk.linear_scan_chunked, (r, k, v, lw, u), kw,
               f"linear_scan_chunked {mode} BH={BH} S={S} Dk={Dk} Dv={Dv} log_w[..,{lw_cols}] "
               f"chunk={chunk}" + (" from a non-zero state0" if with_state else ""), flush, report,
               list_kernels=True)


# the backward's cases: every SCAN_CASES entry, then paths 25-26's training
# scans (2 sequences of 512 tokens a microbatch, chunk 64, a zero state)
SCAN_BWD_TRAIN_CASES = {
    "rwkv": ("bonus", 80, 512, 64, 64, 64, 64, False),        # rwkv6-3b: 2 x 40 heads
    "hymba": ("inclusive", 50, 512, 16, 64, 1, 64, False),    # hymba-1.5b: 2 x 25 SSM heads
}


def scan_bwd_bytes_flops(r, k, v, lw, u, chunk: int, mode: str, state0=None, dstate=None):
    """Least bytes and f32 operations of one ``linear_scan_chunked_bwd``
    call: r, k, v, log w, u, state0, dy and dstate read once, their
    gradients written once.  Per chunk of W tokens: 2 (3 Dk + 2 Dv)
    operations per visible (query, key) pair (A = q_fac k_fac^T, dA = g v^T,
    dq_fac, dk_fac and dv from them); 8 Dk Dv per token for the four
    token-by-state products (the recomputed increment k_state^T v, q_fac^T
    g, k_state G_{c+1} and v G_{c+1}^T); per token, the factors as the
    forward computes them, 12 Dk for dr, dk and the masked exponential
    terms and 3 per log w column for its reverse cumsum; 2 Dk Dv for the
    reverse state pass.  Where the chunk-start state is not zero (the chunks
    after the first, or every chunk from a ``state0``): 2 Dk Dv per token
    for g S_c^T, and 3 Dk Dv for the state's decay and d dl.  Returns
    (bytes, operations, the operations of these that the kernel runs on the
    tensor cores): the pair products, the token-by-state products and g
    S_c^T; the rest (factors, exponentials, the state passes, the cumsum)
    runs in f32 on the CUDA cores."""
    BH, S, Dk = r.shape
    Dv, L = v.shape[-1], lw.shape[-1]
    W = chunk
    n = S // W
    pairs = W * (W + 1) // 2 if mode == "inclusive" else W * (W - 1) // 2
    per_chunk = (pairs * 2 * (3 * Dk + 2 * Dv) + W * (8 * Dk * Dv + 4 * L + 15 * Dk + 3 * L)
                 + 2 * Dk * Dv)
    if mode == "bonus":                         # beta, gamma, their terms in dr, dk, dv, du
        per_chunk += W * (3 * Dk + 2 * Dv + 6 * Dk + 2 * Dv)
    cross = W * 2 * Dk * Dv + 3 * Dk * Dv
    started = n if state0 is not None else n - 1
    flops = BH * (n * per_chunk + started * cross)
    mma = BH * (n * (pairs * 2 * (3 * Dk + 2 * Dv) + W * 8 * Dk * Dv) + started * W * 2 * Dk * Dv)
    tensors = [r, k, v, lw, u, state0, dstate]
    read = sum(x.numel() for x in tensors if x is not None) + BH * S * Dv       # + dy
    written = sum(x.numel() for x in (r, k, v, lw, u, state0) if x is not None)
    return 4 * (read + written), flops, mma


def scan_bwd_check(fn, args: tuple, kw: dict, label: str, flush, report: dict,
                   iters: int = 20, list_kernels: bool = False):
    """Backward kernel vs ``linear_scan_bwd_ref`` on the same operands: each
    gradient within 2e-3 x max(1, max |plain|) overall and per row (as
    ``scan_check`` holds y), two calls equal bit for bit; with
    ``--parent-scan`` (a parent library with a backward) the parent's
    gradients held within the same limit, and both timed in turns p1, c1,
    c2, p2 on the same operands; the plain version's time and the call's
    bounds: all operations at the f32 SIMT rate, and with the products the
    kernel runs on the tensor cores (``scan_bwd_bytes_flops``' third count)
    at the TF32 rate, three passes each; with ``list_kernels`` the device
    time of each CUDA kernel of a call (a profiler window).  Returns (ms,
    plain_ms, bound_ms, bound_by)."""
    from repro_torch.kernels.ref import linear_scan_bwd_ref

    got = fn(*args, **kw)
    again = fn(*args, **kw)
    want = linear_scan_bwd_ref(*args, **kw)
    parent = None if PARENT_SCAN_BWD is None else PARENT_SCAN_BWD(*args, **kw)
    torch.cuda.synchronize()
    names = ("dr", "dk", "dv", "dlog_w", "du", "dstate0")
    errs, ok, worst, parent_worst = {}, True, 0.0, 0.0
    for i, (name, a, b, w) in enumerate(zip(names, got, again, want)):
        if (a is None) != (w is None):
            fail(f"{label}: {name} is {'missing' if a is None else 'unexpected'}")
        if w is None:
            continue
        scale = max(1.0, float(w.abs().max()))
        err = float((a - w).abs().max())
        row, _ = row_err(a, w)
        bitwise = torch.equal(a, b)
        errs[name] = (err, scale, row, bitwise)
        ok = ok and err <= 2e-3 * scale and row <= 1.0 and bitwise
        worst = max(worst, err / scale)
        report["err"] = max(report.get("err", 0.0), err)
        if parent is not None:
            perr = float((parent[i] - w).abs().max()) / scale
            prow, _ = row_err(parent[i], w)
            parent_worst = max(parent_worst, perr / 2e-3, prow)
    timed = turns(lambda: fn(*args, **kw),
                  None if PARENT_SCAN_BWD is None else lambda: PARENT_SCAN_BWD(*args, **kw),
                  iters, flush)
    ms = timed["c1"]
    plain_ms = time_ms(lambda: linear_scan_bwd_ref(*args, **kw), 3, flush)
    names = kernel_breakdown(lambda: fn(*args, **kw), 10, flush) if list_kernels else None
    nbytes, flops, mma = scan_bwd_bytes_flops(*args, kw["chunk"], kw["mode"], kw.get("state0"),
                                              kw.get("dstate"))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    t_tc = max(t_bytes, (3 * mma / TF32_FLOPS + (flops - mma) / F32_FLOPS) * 1e3)
    print(f"  {label}: " + ", ".join(
        f"{n} max_abs_err={e:.3e} (tol 2e-3 x {sc:.3g}; worst row at {rw:.3g} of its limit"
        f"{'' if bw else '; TWO CALLS DIFFER'})" for n, (e, sc, rw, bw) in errs.items())
        + ("" if parent is None else f"; the parent's worst at {parent_worst:.3g} of its limit"))
    print(f"    kernel {times_text(timed)}, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at f32 {F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s); with its {mma / 1e9:.3f} GFLOP of products on the TF32 tensor cores "
          f"({TF32_FLOPS / 1e12:.0f} TFLOP/s, 3 passes) {t_tc:.4f} ms; two calls bitwise "
          f"equal: {all(e[3] for e in errs.values())}"
          + ("; CUDA kernels per call (ms): " + ", ".join(
              f"{key} {val:.4f}" for key, val in names.items()) if names else ""))
    if not ok:
        fail(f"{label} disagrees with its plain version")
    if parent is not None and not parent_worst <= 1.0:
        fail(f"{label}: the parent's backward disagrees with the plain version")
    report["err_over_scale"] = max(report.get("err_over_scale", 0.0), worst)
    report.setdefault("cases", []).append(
        {"what": label, "ms": ms, **{f"ms_{key}": val for key, val in timed.items()},
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "bound_ms_tf32x3": t_tc}
        | ({"kernels": names} if names else {}))
    return ms, plain_ms, bound, by


def scan_bwd_case(case, flush, report: dict, dstate_zero: bool = False,
                  list_kernels: bool = False):
    """``scan_case``'s operands and a seeded dy (and, from a ``state0``, a
    seeded dstate; ``dstate_zero``: the zero gradient a training step's unused
    final state gives) through the backward kernel."""
    from repro_torch.kernels import linear_scan_kernel as lsk

    mode, BH, S, Dk, Dv, lw_cols, chunk, with_state = case
    r, k, v, lw, u = scan_inputs(mode, BH, S, Dk, Dv, lw_cols, S + Dk)
    gen = torch.Generator(device=DEV).manual_seed(S + Dv)
    kw = dict(chunk=chunk, mode=mode, dy=torch.randn(BH, S, Dv, generator=gen, device=DEV))
    if with_state:
        kw["state0"] = torch.randn(BH, Dk, Dv, generator=torch.Generator(device=DEV).manual_seed(S),
                                   device=DEV)
        kw["dstate"] = torch.randn(BH, Dk, Dv, generator=gen, device=DEV)
    elif dstate_zero:
        kw["dstate"] = torch.zeros(BH, Dk, Dv, device=DEV)
    return scan_bwd_check(
        lsk.linear_scan_chunked_bwd, (r, k, v, lw, u), kw,
        f"linear_scan_chunked_bwd {mode} BH={BH} S={S} Dk={Dk} Dv={Dv} log_w[..,{lw_cols}] "
        f"chunk={chunk}" + (" from a non-zero state0 with a final-state gradient" if with_state
                            else ""), flush, report, list_kernels=list_kernels)


def scan_bwd_occupancy() -> dict:
    """Blocks of the backward's pair kernel resident on one SM at rwkv's Dk
    64 and hymba's Dk 16 (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    through the library's ``linear_scan_bwd_blocks_per_sm``)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("linear_scan").linear_scan_bwd_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    out = {Dk: fn(Dk) for Dk in (64, 16)}
    print(f"  linear_scan_chunked_bwd: pair-kernel blocks per SM by Dk {out}")
    if min(out.values()) < 1:
        fail(f"the backward's pair kernel fits no SM: {out}")
    return out


# ---------------------------------------------------------------------------
# quant_pack


QP_CASES = [  # (N, n, d, bits, dtype): phase 5's tiles, the other widths, hymba's head_dim
    (448, 64, 128, 4, torch.float32), (448, 64, 128, 4, torch.bfloat16),
    (448, 64, 128, 2, torch.float32), (448, 64, 128, 8, torch.float32),
    (448, 64, 64, 4, torch.float32)]


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, a NaN equal to any NaN (its payload and sign aside)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0))


def non_finite(x: torch.Tensor) -> torch.Tensor:
    """x with a NaN in column 0, +inf in column 1, -inf in column 2 and both
    in column 4 of tile 0, and a last tile that is all NaN."""
    x = x.clone()
    n = x.shape[1]
    x[0, n // 2, 0] = float("nan")
    x[0, 0, 1] = float("inf")
    x[0, n - 1, 2] = -float("inf")
    x[0, 0, 4], x[0, n - 1, 4] = float("inf"), -float("inf")
    x[-1] = float("nan")
    return x


def quant_pack_bytes(x: torch.Tensor, bits: int) -> int:
    """x read once; packed codes and the two f32 stats written once."""
    N, n, d = x.shape
    return x.numel() * x.element_size() + N * n * d * bits // 8 + 2 * N * d * 4


def quant_pack_phase(flush, report: dict) -> None:
    """``quant_pack`` driven through ``repro_torch.kernels.quantize_chunk``
    (its launch counter set to 0 just before and read just after), then held
    bit for bit against its plain version, also on non-finite input (NaN,
    +-inf, an all-NaN tile; NaN compared as equal) and across two calls, and
    timed at ``QP_CASES`` beside its byte bound (x read once, codes and
    stats written once; ~8 f32 operations per element), the profiler's
    kernel time, the plain version and ``torch.aminmax(x, dim=1)``, a
    read-side yardstick (the port never calls it; no PyTorch call quantizes
    and packs, so there is no library time).  With ``--parent-kernels``
    the parent's kernel is timed in turns and held on the same inputs; its
    mismatch on non-finite input is reported, not failed."""
    from repro_torch import kernels as port_kernels
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels.ref import quant_pack_ref

    x32 = torch.randn(448, 64, 128, generator=torch.Generator(device=DEV).manual_seed(5),
                      device=DEV)
    inputs = {"f32": x32, "bf16": x32.to(torch.bfloat16)}
    cases = [(bits, dt) for bits in (2, 4, 8) for dt in inputs]
    qp.quant_pack.launches = 0
    outs = {case: port_kernels.quantize_chunk(inputs[case[1]], case[0]) for case in cases}
    torch.cuda.synchronize()
    launches = qp.quant_pack.launches
    if launches != len(cases):
        fail(f"quant_pack launches {launches} != {len(cases)} quantize_chunk calls")
    parent = PARENT_KERNELS.get("quant_pack")
    for (bits, dt), got in outs.items():
        x = inputs[dt]
        want = quant_pack_ref(x, bits)
        exact = [torch.equal(a, b) for a, b in zip(got, want)]
        stable = all(torch.equal(a, b) for a, b in zip(got, qp.quant_pack(x, bits)))
        xn = non_finite(x)
        got_n, want_n = qp.quant_pack(xn, bits), quant_pack_ref(xn, bits)
        exact_n = [nan_equal(a, b) for a, b in zip(got_n, want_n)]
        nan_cols = torch.isnan(xn.float()).any(dim=1)
        where = (torch.equal(torch.isnan(got_n[1]), nan_cols)
                 and torch.equal(torch.isnan(got_n[2]), nan_cols))
        print(f"  quant_pack {dt} {bits} bits, {tuple(x.shape)}: packed / scale / zero equal "
              f"to the plain version bit for bit = {exact}, two calls equal = {stable}; "
              f"non-finite input = {exact_n}, NaN stats exactly in the NaN columns = {where}")
        if not (all(exact) and stable and all(exact_n) and where):
            fail(f"quant_pack {dt} {bits} bits differs from its plain version")
        if parent is not None:
            par = [torch.equal(a, b) for a, b in zip(parent(x, bits), want)]
            par_n = [nan_equal(a, b) for a, b in zip(parent(xn, bits), want_n)]
            print(f"    parent's kernel: finite input equal = {par}, non-finite input equal = "
                  f"{par_n}" + ("" if all(par_n) else " (the NaN fault this tree repairs)"))
    report.update(err=0.0, launches=launches, library_ms=None)

    rows = []
    for i, (N, n, d, bits, dtype) in enumerate(QP_CASES):
        x = torch.randn(N, n, d, generator=torch.Generator(device=DEV).manual_seed(6 + i),
                        device=DEV).to(dtype)
        label = f"{N} x [{n}, {d}] {'f32' if dtype == torch.float32 else 'bf16'} {bits} bits"
        tree_fn = lambda: qp.quant_pack(x, bits)                         # noqa: E731
        parent_fn = None if parent is None else (lambda: parent(x, bits))
        timed = turns(tree_fn, parent_fn, 50, flush)
        prof = {"c": sum(kernel_breakdown(tree_fn, 50, flush).values())}
        if parent_fn is not None:
            prof["p"] = sum(kernel_breakdown(parent_fn, 50, flush).values())
        plain = time_ms(lambda: quant_pack_ref(x, bits), 5, flush)
        aminmax = time_ms(lambda: torch.aminmax(x, dim=1), 50, flush)
        aminmax_prof = sum(kernel_breakdown(lambda: torch.aminmax(x, dim=1), 50, flush).values())
        nbytes = quant_pack_bytes(x, bits)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 8 * x.numel() / F32_FLOPS * 1e3
        row = {"what": label, **{f"ms_{k}": v for k, v in timed.items()},
               **{f"profiler_ms_{k}": v for k, v in prof.items()}, "plain_ms": plain,
               "aminmax_ms": aminmax, "aminmax_profiler_ms": aminmax_prof,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "mb": nbytes / 1e6}
        print(f"  quant_pack {label}: kernel {times_text(timed)}; profiler kernel time "
              + ", ".join(f"{'this tree' if k == 'c' else 'parent'} {v:.4f} ms"
                          for k, v in prof.items())
              + f"; plain {plain:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{nbytes / 1e6:.2f} MB); torch.aminmax(x, dim=1) {aminmax:.4f} ms, profiler "
              f"{aminmax_prof:.4f} ms (read-side yardstick, not a library time: no PyTorch call "
              f"quantizes and packs)")
        rows.append(row)
    x = torch.randn(448, 64, 128, generator=torch.Generator(device=DEV).manual_seed(6),
                    device=DEV)
    copy = torch.empty_like(x)
    probe = time_ms(lambda: copy.copy_(x), 50, flush)
    probe_prof = sum(kernel_breakdown(lambda: copy.copy_(x), 50, flush).values())
    print(f"    probe: a device copy of the f32 tiles ({2 * x.numel() * 4 / 1e6:.2f} MB read and "
          f"written) {probe:.4f} ms, profiler {probe_prof:.4f} ms")
    report["cases"] = rows
    report["copy_probe_ms"], report["copy_probe_profiler_ms"] = probe, probe_prof
    for suffix, row in (("", rows[0]), ("_bf16", rows[1])):
        report.update({"ms" + suffix: row["ms_c1"], "plain_ms" + suffix: row["plain_ms"],
                       "bound_ms" + suffix: row["bound_ms"], "bound_by" + suffix: row["bound_by"]})


# ---------------------------------------------------------------------------
# serving


class Capture:
    """Stand-in for ``module.name`` that keeps a copy of the arguments of its
    ``index``-th call (0-based; ``args`` / ``kwargs``) and of each of the
    ``more`` indices (``seen[i]``), and forwards every call."""

    def __init__(self, module, name: str, index: int, *more: int):
        self.module, self.name, self.index = module, name, index
        self.indices = (index,) + more
        self.real = getattr(module, name)
        self.calls = 0
        self.seen = {}
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.calls in self.indices:
            self.seen[self.calls] = (
                [a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in kwargs.items()})
        self.calls += 1
        return self.real(*args, **kwargs)

    @property
    def args(self):
        return self.seen.get(self.index, (None, None))[0]

    @property
    def kwargs(self):
        return self.seen.get(self.index, (None, None))[1]

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)

    @property
    def launches(self) -> int:
        """The wrapped kernel's count (a wrapper bumps its count through its
        module's name, which this stand-in holds while it is installed)."""
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.real.launches = n


class CallCheck:
    """Stand-in for ``module.name`` that forwards every call and, at its
    ``index``-th call (0-based), hands the call's arguments and result to
    ``check(args, kwargs, out)``, keeping what it returns in ``found``.
    It has ``Capture``'s ``seen`` / ``indices`` / ``restore`` for ``drive``."""

    def __init__(self, module, name: str, index: int, check):
        self.module, self.name, self.index, self.check = module, name, index, check
        self.indices = (index,)
        self.real = getattr(module, name)
        self.calls = 0
        self.seen = {}
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        if self.calls == self.index:
            self.seen[self.index] = self.check(args, kwargs, out)
        self.calls += 1
        return out

    @property
    def found(self):
        return self.seen.get(self.index)

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)


def requests(cfg) -> list:
    """The 8 prompts both serving paths answer: raw lengths drawn from
    300-900 and token ids from numpy seed 0."""
    rng = np.random.RandomState(0)
    lengths = rng.randint(300, 901, size=N_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


def kernel_fns() -> dict:
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import linear_scan_kernel as lsk

    from repro_torch.kernels import quant_pack as qp

    return {"gear_decode": gd.gear_decode, "flash_prefill": fp.flash_prefill,
            "gear_compress": gc.gear_compress, "flash_prefill_block": fp.flash_prefill_block,
            "gear_decode_paged": gd.gear_decode_paged,
            "linear_scan_chunked": lsk.linear_scan_chunked,
            "linear_scan_chunked_bwd": lsk.linear_scan_chunked_bwd, "quant_pack": qp.quant_pack}


def drive(eng, cfg, prompts: list, captures: list, new_tokens: int = NEW_TOKENS,
          keep: dict | None = None) -> dict:
    """Serve ``prompts`` through ``Scheduler.run_continuous`` with every
    launch counter set to 0 just before and read just after (``keep``, when
    given, receives the results by rid)."""
    from repro_torch.serving.scheduler import Request, Scheduler

    sched = Scheduler(eng)
    for rid, toks in enumerate(prompts):
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=new_tokens))
    fns = kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = sched.run_continuous()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    finally:
        for c in captures:
            c.restore()
    stats = sched.last_stats
    peak = torch.cuda.max_memory_allocated()
    if len(results) != len(prompts) or any(str(r.status) != "ok" or len(r.tokens) != new_tokens
                                           for r in results):
        fail(f"serving results: {[(r.rid, str(r.status), len(r.tokens)) for r in results]}")
    for r in results:
        if r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: token ids out of range")
    for c in captures:
        if len(c.seen) != len(c.indices):
            fail(f"no live {c.name} call was captured (calls {c.indices} of {c.calls})")
    if keep is not None:
        keep["results"] = {r.rid: r for r in results}
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    summary = {
        "requests": len(results), "prompt_lengths": [len(p) for p in prompts],
        "decode_steps": stats["decode_steps"], "launches": launches,
        "prefill_ms_per_request": [round(r.prefill_s * 1e3, 3) for r in results],
        "decode_tok_per_s": decode_tokens / stats["decode_s"],
        "wall_s": wall, "max_memory_allocated_gb": peak / 1e9,
        "waited_for_pages": stats["waited_for_pages"],
        "page_wait_steps": stats["page_wait_steps"],
    }
    if "pool" in stats:
        summary["pool"] = stats["pool"].as_dict()
    if "prefix" in stats:
        summary["prefix"] = stats["prefix"].as_dict()
        for key in ("prefix_hit_rate", "prefill_toks_saved", "prefix_evictions"):
            summary[key] = stats[key]
    print(f"  served {len(results)} requests, {decode_tokens} decode tokens in "
          f"{stats['decode_steps']} steps: decode {summary['decode_tok_per_s']:.1f} tok/s, "
          f"prefill ms/request {summary['prefill_ms_per_request']}, "
          f"peak memory {summary['max_memory_allocated_gb']:.2f} GB, launches {launches}")
    return summary


def live_check(cap: Capture, plain, label: str, flush, report: dict, bytes_flops,
               rows_of=None, ops_rate: float = F32_FLOPS) -> tuple:
    """Kernel vs plain version on one captured live call's operands, then
    the kernel's and the plain version's times and the call's bound (its
    operations at ``ops_rate``).  (``block_check`` does this for
    ``flash_prefill_block``.)"""
    args, kwargs = cap.args, cap.kwargs
    acc_k, m_k, l_k = cap.real(*args, **kwargs)
    acc_p, m_p, l_p = plain(*args, **kwargs)
    torch.cuda.synchronize()
    rows = slice(None) if rows_of is None else rows_of(args)
    err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None])[rows].abs().max()),
              float((m_k - m_p)[rows].abs().max()))
    print(f"  {label}: kernel vs plain max_abs_err={err:.3e} (tol {DECODE_TOL})")
    if not err <= DECODE_TOL:
        fail(f"live {label} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)
    ms = time_ms(lambda: cap.real(*args, **kwargs), 50, flush)
    plain_ms = time_ms(lambda: plain(*args, **kwargs), 5, flush)
    nbytes, flops = bytes_flops(args, kwargs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ops_rate * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}, {nbytes / 1e6:.2f} MB)")
    return ms, plain_ms, bound, by


DECODE_NAMES = ["q", "k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero", "n_comp"]


def decode_call_bytes_flops(args, kwargs):
    ops_ = dict(zip(DECODE_NAMES, args)) | {k: v for k, v in kwargs.items()
                                            if isinstance(v, torch.Tensor)}
    n_comp = args[7]
    if not isinstance(n_comp, torch.Tensor):
        n_comp = torch.full((args[0].shape[0],), int(n_comp), dtype=torch.int32)
    nbytes, flops = decode_bytes_flops(ops_, n_comp, kwargs["chunk"])
    if len(args) > 8:                                # block tables
        nbytes += args[8].numel() * 4
    return nbytes, flops


def serving(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 1: monolithic prefill, dense layout."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.serving import scheduler as scheduler_mod
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    # layer 0 of decode step 40 (all 4 slots live): its gear_decode operands,
    # and (path 10b) its gear_attend output against the portable attend
    cap = Capture(ops, "gear_decode", 40 * layers)
    att = CallCheck(ops, "gear_attend", 40 * layers, portable_attend_check)
    # the scheduler's sample call of that step (after the 4 admissions'):
    # its final-position logits, for phase 10.2
    smp = Capture(scheduler_mod, "sample", B_SERVE + 40)
    LIVE["path1"] = {}
    summary = drive(eng, cfg, requests(cfg), [cap, att, smp], keep=LIVE["path1"])
    LIVE["path1_logits"] = smp.args[0]
    launches, steps = summary["launches"], summary["decode_steps"]
    if launches["flash_prefill"] != N_REQUESTS * layers:
        fail(f"flash_prefill launches {launches['flash_prefill']} != 8 prefills x {layers}")
    if launches["gear_decode"] < steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} < {steps} steps x {layers}")
    print(f"  live layer-0 step: n_comp per slot "
          f"{[int(x) for x in cap.args[7][::cfg.num_kv_heads]]}")
    rep = reports["gear_decode"]
    rep["ms"], rep["plain_ms"], rep["bound_ms"], rep["bound_by"] = live_check(
        cap, gear_decode_ref, "gear_decode live decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    rep["library_ms"] = None
    timer_check(lambda: cap.real(*cap.args, **cap.kwargs), "gear_decode live decode step", flush,
                rep)
    reports["gear_decode"]["launches_by_path"] = {"monolithic_dense": launches["gear_decode"]}
    reports["flash_prefill"]["launches_by_path"] = {"monolithic_dense": launches["flash_prefill"]}
    err, lengths = att.found
    print(f"  path 10b: live layer-0 gear_attend (the kernel) vs the portable cache.attend on "
          f"the same cache (slot lengths {lengths}): max_abs_err={err:.3e} (tol {ATTEND_TOL})")
    if not err <= ATTEND_TOL:
        fail(f"the portable attend disagrees with gear_attend on a live cache: {err}")
    summary.update(layers=layers, portable_attend_err=err,
                   cache_nbytes=cache_nbytes(model, pol))
    return summary


MESH_REQUESTS = 4             # path 29: path 1's first 4 requests
MESH_TOKENS = 32              # path 29: the first 32 of each one's 96 tokens
WAVE_LAYERS = 8               # path 7's depth (32 until path 29 came: cut to make its room)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single",
               "send", "recv", "barrier")


class CollectiveCalls:
    """Counts the calls of every ``torch.distributed`` collective while
    installed (``with CollectiveCalls() as c: ...``; ``c.calls``).  Every
    collective of the port goes through these functions.  The dry run's
    counter, ``perf.comm_stats.CollectiveCounter``, also reads bytes, but
    routes each of the run's ops through Python and would slow the step
    read beside it (its docstring says which counter is for what)."""

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.calls, self.real = dist, {}, {}
        for name in COLLECTIVES:
            self.real[name] = fn = getattr(dist, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **k)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.dist, name, fn)


def serving_mesh(model, params, cfg, layers: int, flush, reports: dict, path1: dict) -> dict:
    """Path 29: path 1's engine (its weights, gear_kcvt4, monolithic prefill,
    dense layout) on ``make_test_mesh(1, 1)``, one NCCL process, over path
    1's first 4 requests: greedy tokens equal to path 1's bit for bit,
    exactly path 1's ``flash_prefill`` launches per prefill and
    ``gear_decode`` launches per step, no collective (every axis has size
    1), peak memory and decode tok/s beside path 1's.  Its launcher run
    (``--mesh 1x1``) is in phase 21, with the others (:func:`launcher_runs`)."""
    from repro_torch.core.policy import named_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    mesh = make_test_mesh(1, 1)
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 mesh=mesh)
    shared = sum(p is q for p, q in zip(eng.params.parameters(), params.parameters()))
    print(f"  the mesh engine stores {shared} of {len(list(params.parameters()))} parameters "
          f"shared with path 1's model (nothing split on a 1 x 1 mesh)")
    keep = {}
    with CollectiveCalls() as coll:
        summary = drive(eng, cfg, requests(cfg)[:MESH_REQUESTS], [], MESH_TOKENS, keep=keep)
    launches, steps = summary["launches"], summary["decode_steps"]
    ref = path1["launches"]
    per_step = launches["gear_decode"] / steps
    ref_per_step = ref["gear_decode"] / path1["decode_steps"]
    print(f"  per prefill {launches['flash_prefill'] / MESH_REQUESTS:g} flash_prefill (path 1: "
          f"{ref['flash_prefill'] / N_REQUESTS:g}); per step {per_step:g} gear_decode (path 1: "
          f"{ref_per_step:g}); collectives {coll.calls or 'none'}")
    if launches["flash_prefill"] != MESH_REQUESTS * layers or per_step != ref_per_step or any(
            n for k, n in launches.items() if k not in ("flash_prefill", "gear_decode")):
        fail(f"path 29: launches {launches} over {steps} steps are not path 1's per prefill and "
             f"step ({ref} over {path1['decode_steps']} steps)")
    if coll.calls:
        fail(f"path 29: a 1 x 1 mesh issued collectives {coll.calls}")
    mismatch = [rid for rid, r in keep["results"].items() if not np.array_equal(
        r.tokens, LIVE["path1"]["results"][rid].tokens[:MESH_TOKENS])]
    print(f"  greedy tokens of requests 0-{MESH_REQUESTS - 1} bit for bit path 1's first "
          f"{MESH_TOKENS}: "
          f"{not mismatch}; decode {summary['decode_tok_per_s']:.1f} tok/s (path 1: "
          f"{path1['decode_tok_per_s']:.1f} over 8 requests), peak "
          f"{summary['max_memory_allocated_gb']:.2f} GB (path 1: "
          f"{path1['max_memory_allocated_gb']:.2f} GB); {smi()}")
    if mismatch:
        fail(f"path 29: requests {mismatch} leave path 1's tokens")
    record_launches(reports, "mesh_dense", launches)
    summary.update(layers=layers, collectives=coll.calls, shared_params=shared)
    return summary


SAMPLE_TEMPERATURE = 0.8      # phase 10.2
SAMPLED_TOKENS = 16           # phase 10.2: new tokens of each of path 29's 4 requests
# phase 10.2: card and CPU samplers on the same logits may pick other ids only
# where the two best perturbed scores lie this close (the card's f32 division
# by the temperature is IEEE, as the CPU's: none expected)
SAMPLE_MARGIN = 1e-5


def device_launches(fn, iters: int = 5) -> dict:
    """CUDA kernels and copies a call of ``fn`` launches (a ``torch.profiler``
    window of ``iters`` calls): {"kernels": n, "copies": n} per call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out["copies" if e.key.startswith(("Memcpy", "Memset")) else "kernels"] += e.count
    return {k: n / iters for k, n in out.items()}


def serving_sampled(model, params, cfg, layers: int, flush, path29: dict) -> dict:
    """Phase 10.2: the sampler on the card against the CPU's on path 1's
    live logits, then path 29's requests sampled (module docstring)."""
    from repro_torch.core import prng
    from repro_torch.core.policy import named_policy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sampling import sample

    lg = LIVE["path1_logits"]
    if tuple(lg.shape) != (B_SERVE, cfg.vocab_size) or lg.device.type != DEV.type:
        fail(f"path 1's captured logits are {tuple(lg.shape)} on {lg.device}")
    key = prng.fold_in(prng.PRNGKey(0), 40)          # a key of the stream, folded as serving does
    lg_cpu = lg.cpu()
    bits_equal = torch.equal(prng.bits(key, lg.shape, DEV).cpu(), prng.bits(key, lg.shape))
    g_card, g_cpu = prng.gumbel(key, lg.shape, DEV).cpu(), prng.gumbel(key, lg.shape)
    g_ulps = int((g_card.view(torch.int32).long() - g_cpu.view(torch.int32).long()).abs().max())
    print(f"  bits {tuple(lg.shape)} on the card equal to the CPU's: {bits_equal}; gumbel: "
          f"{torch.equal(g_card, g_cpu)} (largest gap {g_ulps} ulps)")
    if not bits_equal:
        fail("the card's threefry bits differ from the CPU's")
    out = {"bits_equal": bits_equal, "gumbel_max_ulps": g_ulps}
    for top_k in (0, 40):
        got = sample(lg, key, SAMPLE_TEMPERATURE, top_k).cpu()
        want = sample(lg_cpu, key, SAMPLE_TEMPERATURE, top_k)
        scores = lg_cpu / SAMPLE_TEMPERATURE
        if top_k:
            kth = torch.topk(scores, top_k, dim=-1).values[..., -1:]
            scores = torch.where(scores < kth, torch.full_like(scores, -1e30), scores)
        top2 = torch.topk(scores + g_cpu, 2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= SAMPLE_MARGIN
        bad = (got != want) & ~near
        launches = device_launches(lambda: sample(lg, key, SAMPLE_TEMPERATURE, top_k))
        ms = time_ms(lambda: sample(lg, key, SAMPLE_TEMPERATURE, top_k), 20, flush)
        print(f"  sample top_k={top_k}: card ids {got.tolist()}, CPU ids {want.tolist()} "
              f"({int(near.sum())} rows within the margin {SAMPLE_MARGIN}); "
              f"{launches['kernels']:g} kernels + {launches['copies']:g} copies a call, "
              f"{ms:.4f} ms device time a call")
        if bad.any():
            fail(f"sample top_k={top_k}: card {got.tolist()} against the CPU's {want.tolist()}")
        out[f"top_k{top_k}"] = {"ids_equal": bool((got == want).all()),
                                "rows_in_margin": int(near.sum()), "ms": ms, **launches}

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol,
                                             temperature=SAMPLE_TEMPERATURE, top_k=40),
                 device=DEV)
    keep = {}
    summary = drive(eng, cfg, requests(cfg)[:MESH_REQUESTS], [], SAMPLED_TOKENS, keep=keep)
    launches, steps = summary["launches"], summary["decode_steps"]
    if launches["flash_prefill"] != MESH_REQUESTS * layers or \
            launches["gear_decode"] < steps * layers:
        fail(f"sampled run: launches {launches} over {steps} steps")
    greedy = LIVE["path1"]["results"]
    same = sum(int(np.array_equal(r.tokens, greedy[rid].tokens[:SAMPLED_TOKENS]))
               for rid, r in keep["results"].items())
    print(f"  sampled run: {MESH_REQUESTS} requests OK, {SAMPLED_TOKENS} ids each in the "
          f"vocabulary; sampler {out['top_k40']['kernels']:g} kernel launches a decode step "
          f"({out['top_k40']['ms']:.4f} ms device time); decode "
          f"{summary['decode_tok_per_s']:.1f} tok/s (path 29, greedy: "
          f"{path29['decode_tok_per_s']:.1f}); {same} of {MESH_REQUESTS} requests equal to "
          f"their greedy tokens; {smi()}")
    summary.update(out, layers=layers, temperature=SAMPLE_TEMPERATURE, top_k=40)
    return summary


def serving_paged(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 2: streaming prefill into the paged pool."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref, gear_decode_paged_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    dense_pages = B_SERVE * (CAP_SERVE // pol.buffer_size)
    pool_pages = dense_pages * 2 // 3 + 1
    eng = Engine(model, params, EngineConfig(
        batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming", layout="paged",
        pool_pages=pool_pages), device=DEV)
    prompts = requests(cfg)
    lengths = [len(p) for p in prompts]
    print(f"  pool: {pool_pages - 1} allocatable pages of {eng.pool.page_bytes / 1e6:.3f} MB "
          f"(the dense layout holds {dense_pages}); lifetime pages per request "
          f"{[-(-(int(n) + NEW_TOKENS - 1) // pol.buffer_size) for n in lengths]}")
    # request 0, layer 0: the K (call 0) and the V (call 1) compression event
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", 0),
            # request 0, layer 0: the history call of its last block (largest extent)
            # request 0, layer 0: every in-flight block's history in one launch
            "gear_decode": Capture(ops, "gear_decode_history", 0),
            "gear_decode_paged": Capture(ops, "gear_decode_paged", 40 * layers)}
    summary = drive(eng, cfg, prompts, list(caps.values()))
    launches, steps = summary["launches"], summary["decode_steps"]
    for name, least in (("gear_compress", 2 * N_REQUESTS * layers),
                        ("flash_prefill_block", N_REQUESTS * layers),
                        ("gear_decode", N_REQUESTS * layers),
                        ("gear_decode_paged", steps * layers)):
        if launches[name] < least:
            fail(f"{name} launches {launches[name]} < {least} on the streaming + paged path")
    if launches["gear_decode"] != N_REQUESTS * layers:
        fail(f"gear_decode launches {launches['gear_decode']} != 8 prefills x {layers}: the "
             f"history of a layer's in-flight blocks is one launch")
    if summary["waited_for_pages"] < 1:
        fail("no decode step ran while a request waited for pages; the pool is not under pressure")
    print(f"  {summary['waited_for_pages']} requests waited for pages, over "
          f"{summary['page_wait_steps']} decode steps; pool {summary['pool']}")
    eng.pool.check()

    c = caps["gear_compress"]
    rep = reports["gear_compress"]
    for index, kind, scheme in ((0, "K", "per_channel"), (1, "V", "per_token")):
        (x, *_), kw = c.seen[index]
        print(f"  live gear_compress {kind} call: {tuple(x.shape)} tiles, {kw}")
        if kw["scheme"] != scheme:
            fail(f"gear_compress call {index} is not the {kind} event ({kw['scheme']})")
        label = f"live layer-0 {kind} event"
        compress_check(x, kw, label, rep)
        row = compress_time(x, kw, label, flush, rep)
        suffix = "" if kind == "K" else "_v"
        rep.update({f"ms{suffix}": row["ms_c1"], f"plain_ms{suffix}": row["plain_ms"],
                    f"bound_ms{suffix}": row["bound_ms"], f"bound_by{suffix}": row["bound_by"]})
    rep["library_ms"] = None

    c = caps["flash_prefill_block"]
    rep = reports["flash_prefill_block"]
    print(f"  live flash_prefill_block call: q {tuple(c.args[0].shape)}, kv_repeat "
          f"{c.kwargs['kv_repeat']}, kv_len in [{int(c.args[3].min())}, {int(c.args[3].max())}]")
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live layer-0 blocks", flush,
                      rep, library=True)
    rep.update(ms=row["ms_c1"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
               bound_by=row["bound_by"], library_ms=row["library_ms"],
               library_note=row["library_note"])

    c = caps["gear_decode"]
    rep = reports["gear_decode"]
    BH, NB, R, _ = c.args[0].shape
    print(f"  live history call (request 0, layer 0): q {tuple(c.args[0].shape)}, extents "
          f"{list(c.args[7])}")
    rep["ms_history"], rep["plain_ms_history"], rep["bound_ms_history"], _ = live_check(
        c, gear_decode_history_ref, f"gear_decode_history live layer-0 history ({NB} blocks x "
        f"{R} query rows, one launch)", flush, rep, history_call_bytes_flops,
        rows_of=lambda a: (torch.as_tensor(list(a[7]), device=DEV) > 0)[None, :, None].expand(
            BH, NB, R), ops_rate=BF16_FLOPS)
    rep["ms_history_per_layer"] = rep["ms_history"]

    c = caps["gear_decode_paged"]
    rep = reports["gear_decode_paged"]
    print(f"  live paged layer-0 step: n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}, block tables "
          f"{c.args[8].tolist()}")
    rep["ms"], rep["plain_ms"], rep["bound_ms"], rep["bound_by"] = live_check(
        c, gear_decode_paged_ref, "gear_decode_paged live decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    rep["library_ms"] = None

    for name in ("gear_compress", "flash_prefill_block", "gear_decode_paged"):
        reports[name]["launches_by_path"] = {"streaming_paged": launches[name]}
    reports["gear_decode"]["launches_by_path"]["streaming_paged"] = launches["gear_decode"]
    summary["layers"] = layers
    return summary


def serving_hybrid(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 3: hymba-1.5b, monolithic prefill, dense layout."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.models import linear_scan as ls_mod
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    prompts = requests(cfg)
    # request 0's layer-0 scan (S = chunk = 859); layer 0 of decode step 40
    caps = {"linear_scan_chunked": Capture(ls_mod, "linear_scan_chunked", 0),
            "gear_decode": Capture(ops, "gear_decode", 40 * layers)}
    summary = drive(eng, cfg, prompts, list(caps.values()))
    launches, steps = summary["launches"], summary["decode_steps"]
    for name, want in (("linear_scan_chunked", N_REQUESTS * layers),
                       ("flash_prefill", N_REQUESTS * layers)):
        if launches[name] != want:
            fail(f"{name} launches {launches[name]} != 8 prefills x {layers} on the hybrid path")
    if launches["gear_decode"] < steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} < {steps} steps x {layers}")
    print(f"  per prefill: {launches['linear_scan_chunked'] // N_REQUESTS} linear_scan_chunked, "
          f"{launches['flash_prefill'] // N_REQUESTS} flash_prefill; per decode step: "
          f"{launches['gear_decode'] / steps:.1f} gear_decode")

    c = caps["linear_scan_chunked"]
    rep = reports["linear_scan_chunked"]
    r, k, v, lw, u = c.args
    print(f"  live linear_scan_chunked call: r {tuple(r.shape)}, v {tuple(v.shape)}, log_w "
          f"{tuple(lw.shape)}, {c.kwargs}")
    rep["ms"], rep["plain_ms"], rep["bound_ms"], rep["bound_by"] = scan_check(
        c.real, tuple(c.args), c.kwargs, "linear_scan_chunked live layer-0 scan", flush, rep,
        iters=50)
    rep["library_ms"] = None
    rep["launches_by_path"] = {"hybrid_dense": launches["linear_scan_chunked"]}

    c = caps["gear_decode"]
    rep = reports["gear_decode"]
    _, G, Dh = c.args[0].shape
    print(f"  live hymba layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep["ms_hymba"], rep["plain_ms_hymba"], rep["bound_ms_hymba"], _ = live_check(
        c, gear_decode_ref, f"gear_decode live hymba decode step (G = {G}, Dh = {Dh})", flush,
        rep, decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    reports["gear_decode"]["launches_by_path"]["hybrid_dense"] = launches["gear_decode"]
    reports["flash_prefill"]["launches_by_path"]["hybrid_dense"] = launches["flash_prefill"]
    summary["layers"] = layers
    return summary


def serving_rwkv(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 4: rwkv6-3b, monolithic prefill, dense layout; every layer of
    every prefill and decode step is one ``linear_scan_chunked`` launch."""
    from repro_torch.core.policy import named_policy
    from repro_torch.models import linear_scan as ls_mod
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")                  # touches no RWKV layer
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    # request 0's layer-0 prefill scan (S = chunk = 859); layer 0 of decode
    # step 40, after the first B_SERVE prefills and before any request ends
    caps = {"prefill": Capture(ls_mod, "linear_scan_chunked", 0),
            "decode": Capture(ls_mod, "linear_scan_chunked", (B_SERVE + 40) * layers)}
    summary = drive(eng, cfg, requests(cfg), list(caps.values()))
    launches, steps = summary["launches"], summary["decode_steps"]
    want = (N_REQUESTS + steps) * layers
    if launches["linear_scan_chunked"] != want:
        fail(f"linear_scan_chunked launches {launches['linear_scan_chunked']} != (8 prefills + "
             f"{steps} steps) x {layers} on the rwkv path")
    others = {k: n for k, n in launches.items() if k != "linear_scan_chunked" and n}
    if others:
        fail(f"kernels other than linear_scan_chunked launched on the rwkv path: {others}")
    if eng.attend_path != "xla":
        fail(f"rwkv engine reports attend path {eng.attend_path!r}, not 'xla'")
    print(f"  {layers} linear_scan_chunked launches per prefill and per decode step "
          f"({launches['linear_scan_chunked']} = (8 + {steps}) x {layers}); attend path "
          f"{eng.attend_path}")
    rep = reports["linear_scan_chunked"]
    for phase, c in caps.items():
        r, k, v, lw, u = c.args
        s0 = c.kwargs.get("state0")
        print(f"  live rwkv {phase} scan: r {tuple(r.shape)}, log_w {tuple(lw.shape)}, chunk "
              f"{c.kwargs['chunk']}, mode {c.kwargs['mode']}, state0 "
              f"{None if s0 is None else tuple(s0.shape)} (max |state0| "
              f"{0.0 if s0 is None else float(s0.abs().max()):.3g})")
        if (phase == "decode") != (s0 is not None and r.shape[1] == 1):
            fail(f"the captured rwkv {phase} scan is not the expected call")
        timed = scan_check(c.real, tuple(c.args), c.kwargs,
                           f"linear_scan_chunked live rwkv layer-0 {phase} scan", flush, rep,
                           iters=50)
        rep.update({f"{key}_rwkv_{phase}": val for key, val in
                    zip(("ms", "plain_ms", "bound_ms", "bound_by"), timed)})
    rep["launches_by_path"]["rwkv_dense"] = launches["linear_scan_chunked"]
    summary["layers"] = layers
    return summary


LIVE = {}                    # what a later phase holds against: path 5's tokens
PREFIX_SYSTEM = 512          # path 5: tokens of the shared system prompt (8 chunks)
PREFIX_SUFFIX = (40, 400)    # path 5: raw length range of each request's own suffix
# path 5's pool: two thirds of the dense-equivalent pages (48 allocatable, as
# path 2) cannot force a reclaim, because the trie's byte budget (256 MiB,
# 17 pages of 15.47 MB at full width) leaves 31 pages free on an idle engine
# and no request needs more than 16.  Shrunk by a third, to 32 allocatable
# pages, the trie's retained pages block the queue head on an idle engine
# (the gate below fails unless a reclaim frees pages).
PREFIX_POOL_PAGES = 33
HYBRID_STREAM_TOKENS = 16    # path 6's budget per request, cut from 96 for time


def prefix_requests(cfg) -> list:
    """Path 5's traffic: one 512-token system prompt (8 chunks) shared by the
    8 requests, each followed by its own user suffix of raw length 40-400,
    all from numpy seed 0 (``bench_prefix.py``'s shared-prefix traffic at
    the main path's scale)."""
    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab_size, size=PREFIX_SYSTEM)
    lengths = rng.randint(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1, size=N_REQUESTS)
    return [np.concatenate([system, rng.randint(0, cfg.vocab_size, size=n)]).astype(np.int32)
            for n in lengths]


def watch_prefills(eng, keep_index: int) -> dict:
    """Wrap ``eng.prefill_slot``: per prefill (in admission order), the trie
    chunks it hit, the kernel launches it made, its device-synchronized ms
    and its logits; for the ``keep_index``-th prefill also its slot's
    closed-chunk pool pages of every layer (copied)."""
    from repro_torch.core.cache import POOLED_FIELDS

    fns = kernel_fns()
    real = eng.prefill_slot
    nb = eng.ecfg.policy.buffer_size
    rec = {"hits": [], "launches": [], "ms": [], "logits": []}

    def wrapped(batch1, caches, slot, admit=True, reserve_tokens=None):
        index = len(rec["ms"])
        pc = eng.prefix_cache
        h0 = pc.stats["hit_chunks"] if pc is not None else 0
        l0 = {name: fn.launches for name, fn in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = real(batch1, caches, slot, admit=admit, reserve_tokens=reserve_tokens)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["launches"].append({name: fn.launches - l0[name] for name, fn in fns.items()})
        rec["hits"].append(pc.stats["hit_chunks"] - h0 if pc is not None else 0)
        rec["logits"].append(logits.clone())
        if index == keep_index:
            n_closed = int(np.asarray(batch1["tokens"]).shape[1]) // nb
            pages = torch.as_tensor(eng.pool.block_tables[slot, :n_closed].astype(np.int64),
                                    device=DEV)
            rec["chunks"] = [{f: t[pages].clone() for f, t in lyr.tensors().items()
                              if f in POOLED_FIELDS} for lyr in caches]
        return logits, caches

    eng.prefill_slot = wrapped
    return rec


def row_count_check(params) -> dict:
    """Layer 0's row-wise prefill products (``wo``, ``w_gate``, ``w_up``,
    ``w_down``; bf16) on the card: the row counts M (64 to the capacity, by
    64) at which a row of ``x[:, :M] @ W`` is not the same row of the
    capacity-row product bit for bit, printed; and the gate: through
    ``common.rowwise`` a suffix's rows equal the cold product's."""
    from repro_torch.models.common import MIN_GEMM_ROWS, rowwise

    gen = torch.Generator(device=DEV).manual_seed(3)
    out = {}
    for name in ("wo", "w_gate", "w_up", "w_down"):
        w = getattr(params.blocks[0], name)
        x = torch.randn(1, CAP_SERVE, w.shape[0], generator=gen, device=DEV).to(torch.bfloat16)
        cold = x @ w
        out[name] = [m for m in range(64, CAP_SERVE + 1, 64)
                     if not torch.equal(x[:, :m] @ w, cold[:, :m])]
        suffixes = ((512, 576), (512, 832), (1088, 1152), (0, 64))
        bad = [(lo, hi) for lo, hi in suffixes
               if not torch.equal(rowwise(lambda t: t @ w, x[:, lo:hi]), cold[:, lo:hi])]
        print(f"  row counts whose {name} {tuple(w.shape)} rows differ from the {CAP_SERVE}-row "
              f"product's: {out[name]}; rowwise (>= {MIN_GEMM_ROWS} rows) suffixes "
              f"{suffixes} equal the cold rows: {not bad}")
        if bad:
            fail(f"rowwise {name} rows of suffixes {bad} differ from the cold product's")
    return out


def serving_prefix(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 5: the prefix trie on the streaming + paged path (phase 11's
    llama2-7b), against the same engine without it."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    nb = pol.buffer_size
    prompts = prefix_requests(cfg)

    def engine(prefix_cache: bool):
        return Engine(model, params, EngineConfig(
            batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming",
            layout="paged", pool_pages=PREFIX_POOL_PAGES, prefix_cache=prefix_cache), device=DEV)

    rows_differ = row_count_check(params)
    warm = engine(True)
    print(f"  raw prompt lengths {[len(p) for p in prompts]} ({PREFIX_SYSTEM}-token system "
          f"prompt + suffix); pool: {PREFIX_POOL_PAGES - 1} allocatable pages of "
          f"{warm._page_bytes / 1e6:.3f} MB (path 2: {B_SERVE * (CAP_SERVE // nb) * 2 // 3}); "
          f"trie budget {warm.ecfg.prefix_cache_bytes / 2**20:.0f} MiB = "
          f"{warm.ecfg.prefix_cache_bytes // warm._page_bytes} pages")
    reclaims = []
    real_reclaim = warm.reclaim_pages
    warm.reclaim_pages = lambda n: reclaims.append((n, real_reclaim(n))) or reclaims[-1][1]
    rec = watch_prefills(warm, keep_index=1)
    # request 1, layer 0: its K compression event and its in-flight and
    # history calls (request 0 made 2 x 32, 32 and 32 of them before)
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 2 * layers),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", layers),
            "gear_decode": Capture(ops, "gear_decode_history", layers)}
    kept = {}
    summary = drive(warm, cfg, prompts, list(caps.values()), keep=kept)
    launches, steps = summary["launches"], summary["decode_steps"]
    print(f"  hits per request (admission order): {rec['hits']}; hit rate "
          f"{summary['prefix_hit_rate']:.4f}, prefill tokens saved "
          f"{summary['prefill_toks_saved']}, trie evictions {summary['prefix_evictions']}; "
          f"reclaims (pages asked, freed) {reclaims}; {summary['waited_for_pages']} requests "
          f"waited for pages over {summary['page_wait_steps']} decode steps")
    if rec["hits"][1] != PREFIX_SYSTEM // nb:
        fail(f"request 1 hit {rec['hits'][1]} chunks, not the system prompt's {PREFIX_SYSTEM // nb}")
    if not any(freed > 0 for _, freed in reclaims):
        fail(f"reclaim_pages never freed a page ({reclaims}); the pool is not small enough")
    warm.pool.check()
    audit = warm.audit()
    if not audit["ok"]:
        fail(f"engine audit: {audit['issues'][:5]}")
    print(f"  pool check and engine audit pass with {len(warm.prefix_cache.live_handles())} "
          f"pages retained by the trie; pool {summary['pool']}")
    n1 = len(prompts[1])
    suffix_closed = n1 // nb - rec["hits"][1]
    hit_l = rec["launches"][1]
    want = {"gear_decode": layers, "flash_prefill_block": layers, "flash_prefill": 0,
            "gear_compress": 2 * layers if suffix_closed else 0, "gear_decode_paged": 0}
    got = {name: hit_l[name] for name in want}
    print(f"  request 1's warm prefill ({n1} tokens, {rec['hits'][1]} chunks hit, "
          f"{suffix_closed} closed by its suffix) launched {got}")
    if got != want:
        fail(f"launches of request 1's warm prefill {got} != {want}")
    (x, *_), kw = caps["gear_compress"].seen[caps["gear_compress"].index]
    if kw["scheme"] != "per_channel" or x.shape[0] != cfg.num_kv_heads * suffix_closed:
        fail(f"request 1's layer-0 K event compressed {x.shape[0]} tiles, not "
             f"{cfg.num_kv_heads} heads x {suffix_closed} suffix chunks")
    if launches["gear_decode_paged"] < steps * layers or launches["flash_prefill"]:
        fail(f"gear_decode_paged launches {launches['gear_decode_paged']} < {steps} steps x "
             f"{layers}, or flash_prefill launched ({launches['flash_prefill']})")

    c = caps["gear_decode"]
    rep = reports["gear_decode"]
    ext = [int(e) for e in c.args[7]]
    print(f"  live history call (request 1, layer 0): q {tuple(c.args[0].shape)}, extents {ext}")
    if ext[0] != PREFIX_SYSTEM:
        fail(f"request 1's first suffix block sees {ext[0]} history tokens, not {PREFIX_SYSTEM}")
    BH, NB, R, _ = c.args[0].shape
    rep["ms_history_prefix"], rep["plain_ms_history_prefix"], rep["bound_ms_history_prefix"], _ = (
        live_check(c, gear_decode_history_ref, f"gear_decode_history live warm layer-0 history "
                   f"({NB} suffix blocks x {R} query rows over a {ext[0]}-token cached prefix)",
                   flush, rep, history_call_bytes_flops, ops_rate=BF16_FLOPS))
    c = caps["flash_prefill_block"]
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live warm layer-0 blocks "
                      f"(request 1's {c.args[0].shape[0] // cfg.num_heads} suffix blocks)", flush,
                      reports["flash_prefill_block"], library=True)
    reports["flash_prefill_block"].update(
        ms_prefix=row["ms_c1"], plain_ms_prefix=row["plain_ms"], bound_ms_prefix=row["bound_ms"],
        library_ms_prefix=row["library_ms"])

    # warm == cold: the same requests without the trie
    cold = engine(False)
    rec_c = watch_prefills(cold, keep_index=1)
    kept_c = {}
    summary_c = drive(cold, cfg, prompts, [], keep=kept_c)
    diff = [rid for rid in kept["results"] if not np.array_equal(
        kept["results"][rid].tokens, kept_c["results"][rid].tokens)]
    logits_diff = [rid for rid in range(N_REQUESTS)
                   if not torch.equal(rec["logits"][rid], rec_c["logits"][rid])]
    same_logits = 1 not in logits_diff
    same_chunks = all(torch.equal(a[f], b[f]) for a, b in zip(rec["chunks"], rec_c["chunks"])
                      for f in a)
    print(f"  warm vs cold engine: greedy tokens differ for rids {diff}, prefill logits for rids "
          f"{logits_diff}; request 1's prefill logits bitwise equal {same_logits}; its "
          f"{n1 // nb} closed chunks of all {layers} layers gathered from the pool bitwise "
          f"equal {same_chunks}")
    if diff or not same_logits or not same_chunks:
        fail("the prefix-cache engine differs from the cold engine (ROADMAP §3)")
    LIVE["path5_tokens"] = {rid: r.tokens for rid, r in kept["results"].items()}
    print(f"  prefill ms per request (admission order), warm engine: "
          f"{[round(t, 1) for t in rec['ms']]} (request 0 cold); cold engine: "
          f"{[round(t, 1) for t in rec_c['ms']]}")
    summary.update(prefill_ms_warm_engine=rec["ms"][:N_REQUESTS],
                   prefill_ms_cold_engine=rec_c["ms"], hits_per_request=rec["hits"][:N_REQUESTS],
                   reclaims=list(reclaims),
                   cold_decode_tok_per_s=summary_c["decode_tok_per_s"],
                   launches_warm_prefill_request1=hit_l, layers=layers,
                   gemm_rows_differ=rows_differ)
    for name in ("gear_decode", "flash_prefill_block", "gear_compress", "gear_decode_paged"):
        reports[name]["launches_by_path"]["prefix_paged"] = launches[name]
    return summary


def serving_hybrid_streaming(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 6: hymba-1.5b with streaming prefill on the dense layout."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol,
                                             prefill_mode="streaming"), device=DEV)
    if eng._can_bucket:
        fail("the hybrid engine buckets its prompts; the reference prefills a hybrid unbucketed")
    prompts = requests(cfg)
    # request 0, layer 0: the K (call 0) and the V (call 1) compression event
    # at head_dim 64, its in-flight blocks and its history call
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", 0),
            "gear_decode": Capture(ops, "gear_decode_history", 0)}
    rec = watch_prefills(eng, keep_index=-1)
    summary = drive(eng, cfg, prompts, list(caps.values()), new_tokens=HYBRID_STREAM_TOKENS)
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill_block": layers, "gear_decode": layers, "linear_scan_chunked": layers,
            "flash_prefill": 0, "gear_compress": 2 * layers}
    for i, got_all in enumerate(rec["launches"]):
        got = {name: got_all[name] for name in want}
        if got != want:
            fail(f"hybrid streaming prefill {i} launched {got} != {want}")
    if launches["gear_decode"] != (N_REQUESTS + steps) * layers:
        fail(f"gear_decode launches {launches['gear_decode']} != (8 prefills + {steps} steps) x "
             f"{layers}: one history launch per prefill layer, one decode launch per step layer")
    print(f"  per prefill: {want}; per decode step: {layers} gear_decode "
          f"({launches['gear_decode']} = (8 + {steps}) x {layers})")
    c = caps["gear_compress"]
    rep = reports["gear_compress"]
    for index, kind, scheme in ((0, "K", "per_channel"), (1, "V", "per_token")):
        (x, *_), kw = c.seen[index]
        print(f"  live hymba gear_compress {kind} call: {tuple(x.shape)} tiles, {kw}")
        if kw["scheme"] != scheme or x.shape[-1] != cfg.head_dim:
            fail(f"hymba gear_compress call {index} is not the {kind} event at head_dim "
                 f"{cfg.head_dim} ({kw['scheme']}, {tuple(x.shape)})")
        label = f"live hymba layer-0 {kind} event (head_dim {x.shape[-1]})"
        compress_check(x, kw, label, rep)
        row = compress_time(x, kw, label, flush, rep)
        suffix = "_hymba_k" if kind == "K" else "_hymba_v"
        rep.update({f"ms{suffix}": row["ms_c1"], f"plain_ms{suffix}": row["plain_ms"],
                    f"bound_ms{suffix}": row["bound_ms"]})
    c = caps["flash_prefill_block"]
    print(f"  live flash_prefill_block call: q {tuple(c.args[0].shape)}, kv_repeat "
          f"{c.kwargs['kv_repeat']}")
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live hymba layer-0 blocks "
                      f"(kv_repeat {c.kwargs['kv_repeat']}, Dh {c.args[0].shape[-1]})", flush,
                      reports["flash_prefill_block"], library=True)
    reports["flash_prefill_block"].update(
        ms_hymba=row["ms_c1"], plain_ms_hymba=row["plain_ms"], bound_ms_hymba=row["bound_ms"],
        library_ms_hymba=row["library_ms"])
    c = caps["gear_decode"]
    BH, NB, R, Dh = c.args[0].shape
    print(f"  live hymba history call: q {tuple(c.args[0].shape)} ({R} query rows = "
          f"{cfg.num_heads // cfg.num_kv_heads} heads x 64), extents {list(c.args[7])}")
    rep = reports["gear_decode"]
    (rep["ms_history_hymba"], rep["plain_ms_history_hymba"], rep["bound_ms_history_hymba"],
     _) = live_check(c, gear_decode_history_ref, f"gear_decode_history live hymba layer-0 "
                     f"history ({NB} blocks x {R} query rows, Dh {Dh})", flush, rep,
                     history_call_bytes_flops,
                     rows_of=lambda a: (torch.as_tensor(list(a[7]), device=DEV) > 0)[
                         None, :, None].expand(BH, NB, R), ops_rate=BF16_FLOPS)
    for name in ("flash_prefill_block", "gear_decode", "linear_scan_chunked", "gear_compress"):
        reports[name]["launches_by_path"]["hybrid_streaming"] = launches[name]
    summary.update(layers=layers, prefill_ms_by_admission=rec["ms"][:N_REQUESTS])
    return summary


def watch_waves(eng) -> dict:
    """Wrap ``eng.prefill`` and ``eng.generate``: per wave, the prefill's
    kernel launches and logits and ``generate``'s stats."""
    fns = kernel_fns()
    real_prefill, real_generate = eng.prefill, eng.generate
    rec = {"launches": [], "logits": [], "stats": []}

    def prefill(batch):
        l0 = {name: fn.launches for name, fn in fns.items()}
        logits, caches = real_prefill(batch)
        rec["launches"].append({name: fn.launches - l0[name] for name, fn in fns.items()})
        rec["logits"].append(logits.clone())
        return logits, caches

    def generate(*args, **kwargs):
        toks, stats = real_generate(*args, **kwargs)
        rec["stats"].append(stats)
        return toks, stats

    eng.prefill, eng.generate = prefill, generate
    return rec


def serving_wave(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 7: wave mode (``Scheduler.run`` / ``Engine.generate``) on phase
    10's llama2-7b: monolithic prefill of a whole wave at batch 4, dense
    layout, lockstep decode."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import Request, Scheduler, _pad

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    prompts = requests(cfg)
    waves = [list(range(w, w + B_SERVE)) for w in range(0, N_REQUESTS, B_SERVE)]
    pads = [max(len(prompts[r]) for r in wave) for wave in waves]
    padded = [np.stack([_pad(prompts[r], pad) for r in wave]) for wave, pad in zip(waves, pads)]
    rec = watch_waves(eng)
    # wave 0's layer-0 attention (BHq = 4 x 32 = 128 rows); layer 0 of its decode step 40
    caps = {"flash_prefill": Capture(ops, "flash_prefill", 0),
            "gear_decode": Capture(ops, "gear_decode", 40 * layers)}
    sched = Scheduler(eng)
    for rid, toks in enumerate(prompts):
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=NEW_TOKENS))
    fns = kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    finally:
        for c in caps.values():
            c.restore()
        del eng.prefill, eng.generate
    peak = torch.cuda.max_memory_allocated()
    if len(results) != N_REQUESTS or any(str(r.status) != "ok" or len(r.tokens) != NEW_TOKENS
                                         for r in results):
        fail(f"wave results: {[(r.rid, str(r.status), len(r.tokens)) for r in results]}")
    if sorted(r.rid for r in results) != list(range(N_REQUESTS)):
        fail(f"wave results' rids {[r.rid for r in results]}")
    for r in results:
        if r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: token ids out of range")
    steps = len(waves) * (NEW_TOKENS - 1)
    per_wave = [lw["flash_prefill"] for lw in rec["launches"]]
    if per_wave != [layers] * len(waves) or launches["flash_prefill"] != len(waves) * layers:
        fail(f"flash_prefill launches per wave prefill {per_wave} != {layers} each")
    if launches["gear_decode"] != steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} != {steps} steps x {layers}")
    for c in caps.values():
        if len(c.seen) != len(c.indices):
            fail(f"no live {c.name} call was captured (calls {c.indices} of {c.calls})")
    prefill_s = [st["prefill_s"] for st in rec["stats"]]
    tok_s = [st["decode_tok_per_s"] for st in rec["stats"]]
    print(f"  {len(waves)} waves left-padded to {pads} tokens: prefill s per wave "
          f"{[round(t, 3) for t in prefill_s]}, decode tok/s per wave "
          f"{[round(t, 1) for t in tok_s]}, wall {wall:.1f} s, peak memory {peak / 1e9:.2f} GB; "
          f"launches {launches} ({layers} flash_prefill per wave prefill, {layers} gear_decode "
          f"per step over {steps} steps)")

    # the live BHq-128 flash_prefill call against its plain version, timed beside SDPA
    c = caps["flash_prefill"]
    BH, S, Dh = c.args[0].shape
    if (BH, S) != (B_SERVE * cfg.num_heads, pads[0]):
        fail(f"the captured flash_prefill call is [{BH}, {S}, {Dh}], not wave 0's layer 0")
    flash_live(c, "flash_prefill live wave layer-0 call", flush, reports["flash_prefill"],
               "_wave")

    # the live decode step's layer-0 cache against the plain version
    c = caps["gear_decode"]
    print(f"  live wave layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep = reports["gear_decode"]
    rep["ms_wave"], rep["plain_ms_wave"], rep["bound_ms_wave"], _ = live_check(
        c, gear_decode_ref, "gear_decode live wave decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)

    # batch 4 computes what batch 1 does: each wave row's last-position
    # prefill logits against a batch-1 prefill of the same padded prompt, bit
    # for bit (every GEMM of the prefill gives a row the same bits at 859 and
    # 4 x 859 rows on the H100; a row that reads another row or a shifted
    # mask would not)
    row_err, equal_rows = 0.0, 0
    for w, rows in enumerate(padded):
        for i in range(B_SERVE):
            one, _ = eng.prefill({"tokens": rows[i:i + 1]})
            diff = float((one[0].float() - rec["logits"][w][i].float()).abs().max())
            row_err = max(row_err, diff)
            equal_rows += int(torch.equal(one[0], rec["logits"][w][i]))
    print(f"  wave rows vs batch-1 prefills of the same padded prompts: last-position logits "
          f"max_abs_err={row_err:.4e}; {equal_rows} of {N_REQUESTS} rows bit for bit")
    if equal_rows != N_REQUESTS:
        fail(f"a batch-{B_SERVE} wave row differs from its batch-1 prefill by {row_err}")
    reports["flash_prefill"]["launches_by_path"]["wave_dense"] = launches["flash_prefill"]
    reports["gear_decode"]["launches_by_path"]["wave_dense"] = launches["gear_decode"]
    torch.cuda.synchronize()
    profile_window(lambda: eng.prefill({"tokens": padded[0]}), HERE / "build" / "profile",
                   "wave_dense", "prefill")
    return {"layers": layers, "wave_pads": pads, "prefill_s_per_wave": prefill_s,
            "decode_tok_per_s_per_wave": tok_s, "decode_steps": steps, "launches": launches,
            "wall_s": wall, "max_memory_allocated_gb": peak / 1e9,
            "row_vs_batch1_max_abs_err": row_err, "rows_bit_equal": equal_rows}


# path 8's fault schedule: each site fires once, at a visit every run reaches
# (admissions, splice attempts and guarded prefills number at least 8, decode
# steps and scheduler iterations hundreds)
RESILIENCE_EVENTS = (("pool_exhausted", 1), ("prefill_error", 2), ("nan_chunk", 3),
                     ("decode_error", 10), ("trie_evict", 20))


def serving_resilience(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 8: path 5's engine and traffic with telemetry on and a seeded
    fault injector on a fake clock; every request that completes gives path
    5's tokens bit for bit."""
    from repro_torch.core.policy import named_policy
    from repro_torch.serving import (Engine, EngineConfig, FakeClock, FaultEvent, FaultInjector,
                                     ObsConfig, Request, RetryPolicy, Scheduler)

    pol = named_policy("gear_kcvt4")
    clock = FakeClock()
    eng = Engine(model, params, EngineConfig(
        batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming", layout="paged",
        pool_pages=PREFIX_POOL_PAGES, prefix_cache=True, obs=ObsConfig()), device=DEV,
        clock=clock)
    inj = FaultInjector(seed=0, clock=clock,
                        schedule=[FaultEvent(site, at) for site, at in RESILIENCE_EVENTS])
    sched = Scheduler(eng, faults=inj, retry=RetryPolicy(max_attempts=3))
    prompts = prefix_requests(cfg)
    for rid, toks in enumerate(prompts):
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=NEW_TOKENS))
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = sched.run_continuous()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    stats = sched.last_stats
    statuses = {r.rid: str(r.status) for r in results}
    print(f"  injector log {inj.log}; statuses {stats['statuses']} "
          f"({dict(sorted(statuses.items()))}); attempts "
          f"{ {r.rid: r.attempts for r in results} }; {stats['decode_steps']} decode steps, "
          f"wall {wall:.1f} s, launches {launches}")
    audit = sched.audit(results)
    if len(results) != N_REQUESTS or not audit["ok"]:
        fail(f"path 8: {len(results)} results, audit {audit['issues'][:5]}")
    missing = [site for site, _ in RESILIENCE_EVENTS if inj.fired[site] < 1]
    if missing:
        fail(f"fault sites that never fired: {missing} (log {inj.log})")
    victims = [r.rid for r in results if str(r.status) == "failed" and "quarantine" in r.error]
    if len(victims) != inj.fired["nan_chunk"]:
        fail(f"nan_chunk fired {inj.fired['nan_chunk']}x but FAILED by quarantine: {victims}")
    done = [r for r in results if str(r.status) in ("ok", "degraded")]
    if len(done) + len(victims) != N_REQUESTS:
        fail(f"unexpected statuses {statuses}")
    want = LIVE["path5_tokens"]
    diff = [r.rid for r in done if not np.array_equal(r.tokens, want[r.rid])]
    if diff:
        fail(f"completed requests {diff} differ from path 5's tokens")
    cov = eng.obs.tracer.coverage(range(N_REQUESTS))
    if not cov["complete"] or cov["statuses"] != statuses:
        fail(f"trace coverage {cov}")
    fired = {s["labels"]["site"]: s["value"]
             for s in eng.obs.registry.get("serving_faults_injected_total").series()}
    if fired != {site: float(n) for site, n in inj.fired.items() if n}:
        fail(f"the metrics count fired sites {fired}, the injector {inj.fired}")
    by_status = {s["labels"]["status"]: s["value"]
                 for s in eng.obs.registry.get("serving_results_total").series()}
    if by_status != {k: float(v) for k, v in stats["statuses"].items()}:
        fail(f"serving_results_total {by_status} != {stats['statuses']}")
    print(f"  one result per rid and the audit pass; the quarantine victim {victims} FAILED; "
          f"{len(done)} completed requests equal path 5's tokens bit for bit; traces complete "
          f"for all {N_REQUESTS} rids; serving_faults_injected_total {fired}")
    for name in ("gear_decode", "flash_prefill_block", "gear_compress", "gear_decode_paged"):
        reports[name]["launches_by_path"]["resilience_paged"] = launches[name]
    return {"layers": layers, "injector_log": inj.log, "statuses": stats["statuses"],
            "attempts": {r.rid: r.attempts for r in results}, "decode_steps": stats["decode_steps"],
            "launches": launches, "wall_s": wall, "faults_metric": fired}


ATTEND_TOL = 3e-2             # portable attend vs gear_attend (tests/test_cache.py:118)
FP16_ATTEND_RTOL = 1e-2       # FP16 attend (bf16 out) vs f64, relative to max(1, |out|)
PER_TOKEN_TOKENS = 16         # path 10a's budget per request, cut from 96 for time


def portable_attend_check(args, kwargs, out):
    """Path 10b: a live ``gear_attend`` call's output against the portable
    ``cache.attend`` on the same cache and query."""
    from repro_torch.core import cache as cache_lib

    ccfg, cache, q, scale = args
    want = cache_lib.attend(ccfg, cache, q, scale)
    return float((want.float() - out.float()).abs().max()), [int(x) for x in cache.length]


def cache_nbytes(model, pol) -> int:
    """``Engine.cache_nbytes`` of a batch-4, capacity-1152 tree of ``pol``
    (built on the meta device: no memory)."""
    from repro_torch.serving.engine import Engine

    return Engine.cache_nbytes(model.init_caches(pol, B_SERVE, CAP_SERVE, device="meta"))


def record_launches(reports: dict, path: str, launches: dict) -> None:
    for name, n in launches.items():
        reports[name].setdefault("launches_by_path", {})[path] = n


def serving_fp16(model, params, cfg, layers: int, flush, reports: dict, gear: dict) -> dict:
    """Path 9: the paper's FP16 baseline (monolithic prefill, dense layout),
    beside path 1's gear_kcvt4 readings ``gear``."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("fp16")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)

    def f64_check(args, kwargs, out):
        ccfg, cache, q, scale = args
        B, Hq, Dh = q.shape
        H = ccfg.kv_heads
        qd = q.double().reshape(B, H, Hq // H, Dh)
        s = torch.einsum("bhgd,bhsd->bhgs", qd, cache.k.double()) * scale
        valid = torch.arange(cache.k.shape[2], device=q.device)[None, :] < cache.length[:, None]
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        want = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(s, dim=-1), cache.v.double())
        want = want.reshape(B, Hq, Dh)
        err = float((out.double() - want).abs().max())
        return err, err / max(1.0, float(want.abs().max())), [int(x) for x in cache.length]

    chk = CallCheck(cache_lib, "attend", 40 * layers, f64_check)   # layer 0, step 40
    summary = drive(eng, cfg, requests(cfg), [chk])
    launches = summary["launches"]
    if launches["flash_prefill"] != N_REQUESTS * layers:
        fail(f"flash_prefill launches {launches['flash_prefill']} != 8 prefills x {layers}")
    if launches["gear_decode"] or launches["gear_decode_paged"] or launches["gear_compress"]:
        fail(f"the FP16 path launched a GEAR kernel: {launches}")
    err, rel, lengths = chk.found
    print(f"  live layer-0 FP16 decode attend (slot lengths {lengths}) vs f64 softmax(q K^T) V: "
          f"max_abs_err={err:.3e}, relative {rel:.3e} (tol {FP16_ATTEND_RTOL})")
    if not rel <= FP16_ATTEND_RTOL:
        fail(f"the FP16 decode attend disagrees with f64: {err}")
    summary.update(layers=layers, attend_err=err, cache_nbytes=cache_nbytes(model, pol))
    print(f"  FP16 vs gear_kcvt4 (path 1, depth {gear['layers']}; {smi()}): decode tok/s "
          f"{summary['decode_tok_per_s']:.1f} vs {gear['decode_tok_per_s']:.1f}; prefill ms per "
          f"request {summary['prefill_ms_per_request']} vs {gear['prefill_ms_per_request']}; "
          f"max_memory_allocated {summary['max_memory_allocated_gb']:.3f} vs "
          f"{gear['max_memory_allocated_gb']:.3f} GB; cache_nbytes "
          f"{summary['cache_nbytes'] / 1e9:.3f} vs {gear['cache_nbytes'] / 1e9:.3f} GB")
    record_launches(reports, "fp16_dense", launches)
    return summary


def serving_per_token_paged(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 10a: per_token_q4 on the paged layout through ``attend_paged``."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("per_token_q4")
    pages = B_SERVE * (CAP_SERVE // pol.buffer_size) * 2 // 3 + 1     # path 2's pool
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol,
                                             layout="paged", pool_pages=pages), device=DEV)
    if eng.attend_path != "xla":
        fail(f"per_token_q4 reports attend path {eng.attend_path!r}, not the reference's 'xla'")

    def gathered(args, kwargs, out):
        ccfg, pcache, bt, q, scale = args
        want = cache_lib.attend(ccfg, cache_lib.paged_to_dense(ccfg, pcache, bt), q, scale)
        return bool(torch.equal(want, out)), [int(x) for x in pcache.length]

    chk = CallCheck(cache_lib, "attend_paged", 8 * layers, gathered)    # layer 0, step 8
    summary = drive(eng, cfg, requests(cfg), [chk], new_tokens=PER_TOKEN_TOKENS)
    launches = summary["launches"]
    if launches["gear_decode"] or launches["gear_decode_paged"]:
        fail(f"per_token_q4 decode launched gear_decode: {launches}")
    if launches["flash_prefill"] != N_REQUESTS * layers:
        fail(f"flash_prefill launches {launches['flash_prefill']} != 8 prefills x {layers}")
    same, lengths = chk.found
    print(f"  live layer-0 attend_paged (slot lengths {lengths}) equals attend on the gathered "
          f"dense cache bit for bit: {same}; pool {summary['pool']}")
    if not same:
        fail("attend_paged differs from attend on the gathered dense cache")
    summary.update(layers=layers, cache_nbytes=cache_nbytes(model, pol))
    record_launches(reports, "per_token_paged", launches)
    return summary


def serving_telemetry(model, params, cfg, layers: int, flush, reports: dict,
                      path5: dict) -> dict:
    """Path 11: path 5's engine and traffic with telemetry on, then with the
    fidelity probes; both must give path 5's tokens bit for bit."""
    from repro_torch.core.policy import named_policy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving import ObsConfig

    pol = named_policy("gear_kcvt4")
    out = {"layers": layers, "path5_wall_s": path5["wall_s"]}
    for key, obs in (("obs_on", ObsConfig()), ("probes_on", ObsConfig(fidelity_every_n=1))):
        eng = Engine(model, params, EngineConfig(
            batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming",
            layout="paged", pool_pages=PREFIX_POOL_PAGES, prefix_cache=True, obs=obs), device=DEV)
        kept = {}
        summary = drive(eng, cfg, prefix_requests(cfg), [], keep=kept)
        diff = [rid for rid, r in kept["results"].items()
                if not np.array_equal(r.tokens, LIVE["path5_tokens"][rid])]
        print(f"  {key}: wall {summary['wall_s']:.2f} s (path 5, telemetry off: "
              f"{path5['wall_s']:.2f} s); requests whose tokens differ from path 5's: {diff}")
        if diff:
            fail(f"{key}: tokens differ from path 5's for rids {diff}")
        record_launches(reports, f"telemetry_paged_{key}", summary["launches"])
        out[key] = {"wall_s": summary["wall_s"], "decode_tok_per_s": summary["decode_tok_per_s"],
                    "launches": summary["launches"]}
    reg = eng.obs.registry
    probes = int(reg.get("fidelity_probes_total").value())
    errors = int(reg.get("fidelity_probe_errors_total").value())
    skipped = int(reg.get("fidelity_probe_skipped_total").value())
    reps = list(eng.obs.fidelity.reports)
    flash = out["probes_on"]["launches"]["flash_prefill"]
    print(f"  fidelity: {probes} probes, {skipped} skipped by the budget, {errors} errors; "
          f"{flash} flash_prefill launches (the FP16 shadow prefills)")
    if errors or probes < 1 or len(reps) != probes:
        fail(f"fidelity probes: {probes} run, {errors} errors, {len(reps)} reports")
    if flash != probes * layers:
        fail(f"flash_prefill launches {flash} != {probes} shadow prefills x {layers}")
    rows = [row for rep in reps for row in rep["layers"]]
    if {row["layer"] for row in rows} != set(range(layers)):
        fail(f"layers in the probe reports: {sorted({row['layer'] for row in rows})}")
    errs = {f: np.array([row[f"{f}_rel_err"] for row in rows]) for f in ("k", "v")}
    if not all(np.isfinite(e).all() for e in errs.values()):
        fail("a probe reported a non-finite K/V relative error")
    by_layer = {f: np.array([[row[f"{f}_rel_err"] for row in rows if row["layer"] == i]
                             for i in range(layers)]) for f in ("k", "v")}
    stats = {f: {"median_of_layer_medians": float(np.median(np.median(a, axis=1))),
                 "max": float(a.max()), "layer_of_max": int(a.max(axis=1).argmax())}
             for f, a in by_layer.items()}
    drift = [rep["logits_drift"] for rep in reps]
    print(f"  probes on prompts of {[rep['prompt_tokens'] for rep in reps]} tokens "
          f"({[rep['closed_chunks'] for rep in reps]} closed chunks): K/V relative error "
          f"{stats}; logit drift {drift} (random weights: these describe random activations)")
    out.update(probes=probes, skipped=skipped, errors=errors, rel_err=stats, logits_drift=drift,
               reports=reps)
    return out


# the serving launcher's runs, at full width (a smoke config's head_dim 16 has
# no kernel build); "mesh_wave" is path 29's, the wave run on a 1 x 1 mesh
WAVE_ARGS = ["--arch", "llama2-7b", "--batch", "4", "--prompt", "512", "--gen", "16"]
WAVE_LINE = (r"generated \(4, 16\); prefill [0-9.]+s, decode [0-9.]+s \([0-9.]+ tok/s\), "
             r"cache [0-9.]+ MB")
LAUNCHER_RUNS = {
    "wave": WAVE_ARGS,
    "continuous": ["--arch", "llama2-7b", "--batch", "4", "--prompt", "512", "--gen", "16",
                   "--mode", "continuous", "--layout", "paged", "--requests", "8", "--obs",
                   "--metrics-json", "build/serve/metrics.json",
                   "--trace-out", "build/serve/trace.json"],
    "mesh_wave": WAVE_ARGS + ["--mesh", "1x1"],
}
LAUNCHER_LINES = {
    "wave": [WAVE_LINE],
    "continuous": [r"served 8 requests \(128 tokens\) in [0-9.]+s; attend=fused layout=paged; "
                   r"pool \d+/\d+ pages used, \d+ shared",
                   r"obs: traces 8/8 rids complete=True",
                   r"obs: metrics snapshot -> build/serve/metrics\.json",
                   r"obs: chrome trace -> build/serve/trace\.json"],
    "mesh_wave": [WAVE_LINE],
}


def run_together(cmds: dict, timeout: float = 600.0) -> dict:
    """Start every command of ``cmds`` (name -> arguments after ``python``)
    at once, from the repository root with ``src`` on the path, and wait for
    all of them: name -> ``{"returncode", "stdout" (lines), "stderr",
    "seconds"}``, ``seconds`` from the common start to when this process saw
    the command's end.  Output goes to files under ``build/runs/`` (no pipe
    to fill).  A command still running at ``timeout`` is killed; every
    process started has ended when this returns."""
    import os

    out_dir = HERE / "build" / "runs"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, argv in cmds.items():
            with open(out_dir / f"{name}.out", "w") as so, open(out_dir / f"{name}.err", "w") as se:
                procs[name] = subprocess.Popen([sys.executable, *argv], cwd=HERE, env=env,
                                               stdout=so, stderr=se, text=True)
        done = {}
        for name, proc in procs.items():
            try:
                proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                pass
            done[name] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: {"returncode": proc.returncode,
                   "stdout": (out_dir / f"{name}.out").read_text().strip().splitlines(),
                   "stderr": (out_dir / f"{name}.err").read_text(), "seconds": done[name]}
            for name, proc in procs.items()}


def launcher_runs(extra: tuple = ()) -> dict:
    """``python -m repro_torch.launch.serve`` at full width, as a user runs
    it, with no ``--device`` (so on the card): in wave mode on one device,
    in continuous + paged + telemetry mode, and path 29's wave run on a
    1 x 1 mesh (``--mesh 1x1``), the three started together
    (:func:`run_together`); each must exit 0 and print the reference
    launcher's lines, and the metrics and trace JSON must parse."""
    out_dir = HERE / "build" / "serve"
    for f in ("metrics.json", "trace.json"):
        (out_dir / f).unlink(missing_ok=True)
    runs = run_together({name: ["-m", "repro_torch.launch.serve", *argv, *extra]
                         for name, argv in LAUNCHER_RUNS.items()})
    summary = {}
    for name, run in runs.items():
        lines = run["stdout"]
        print(f"  -m repro_torch.launch.serve {' '.join([*LAUNCHER_RUNS[name], *extra])}: exit "
              f"{run['returncode']}, ended by {run['seconds']:.1f} s")
        for line in lines:
            print(f"    {line}")
        if run["returncode"] != 0:
            fail(f"the launcher ({name}) exited {run['returncode']}: {run['stderr'][-2000:]}")
        want = LAUNCHER_LINES[name]
        if len(lines) != len(want) or not all(re.fullmatch(w, line)
                                              for w, line in zip(want, lines)):
            fail(f"the launcher ({name}) printed {lines}, not {want}")
        summary[name] = {"seconds": run["seconds"], "stdout": lines}
    metrics = json.loads((out_dir / "metrics.json").read_text())
    trace = json.loads((out_dir / "trace.json").read_text())
    series = {m["name"]: m["series"] for m in metrics["metrics"]}
    submitted = series["serving_requests_submitted_total"][0]["value"]
    rids = sorted({e["tid"] for e in trace["traceEvents"] if e["name"] == "request"})
    print(f"  metrics JSON ({metrics['schema']}, {len(series)} metrics, {submitted:.0f} "
          f"submitted) and trace JSON ({trace['schema']}, {len(trace['traceEvents'])} events, "
          f"rids {rids}) parse")
    if submitted != 8 or rids != list(range(8)):
        fail(f"the launcher's telemetry counts {submitted} submits, traces rids {rids}")
    return summary



# ---------------------------------------------------------------------------
# paths 12-15: gemma-2b, starcoder2-3b and minicpm-2b (ROADMAP queue 1, items 8.1-8.3)


FAMILY_TOKENS = 16           # paths 13-15's budget per request, cut from 96 for time


def flash_live(c, label: str, flush, rep: dict, suffix: str) -> None:
    """A captured live ``flash_prefill`` call against its plain version
    (PREFILL_TOL), then the kernel, the plain version and SDPA (GQA expanded
    to the query heads; a window or prefix as a boolean mask) timed beside
    the call's bound, as ``<key><suffix>``."""
    from repro_torch.kernels.ref import flash_prefill_ref

    (q, k, v), kw = c.args, c.kwargs
    BH, S, Dh = q.shape
    o_k, o_p = c.real(q, k, v, **kw), flash_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    print(f"  {label} (BHq {BH}, S {S}, Dh {Dh}, {kw}): kernel vs plain max_abs_err={err:.3e} "
          f"(tol {PREFILL_TOL})")
    if not err <= PREFILL_TOL:
        fail(f"live {label} disagrees with its plain version: {err}")
    rep["err"] = max(rep.get("err", 0.0), err)
    rep_k = kw.get("kv_repeat", 1)
    window, prefix = kw.get("window", 0), kw.get("prefix_len", 0)
    qs, ks, vs = q[None], k[None].repeat_interleave(rep_k, 1), v[None].repeat_interleave(rep_k, 1)
    mask = flash_mask(S, window, prefix)
    ms = time_ms(lambda: c.real(q, k, v, **kw), 20, flush)
    plain = time_ms(lambda: flash_prefill_ref(q, k, v, **kw), 3, flush)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=mask is None), 20, flush)
    nbytes, flops = flash_bytes_flops(S, BH, rep_k, Dh, window, prefix)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    rep.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain, f"library_ms{suffix}": lib,
                f"bound_ms{suffix}": max(t_bytes, t_ops),
                f"bound_by{suffix}": "operations" if t_ops >= t_bytes else "bytes"})
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms ({rep[f'bound_by{suffix}']})")


def serving_family(model, params, cfg, layers: int, flush, reports: dict, path: str,
                   suffix: str, new_tokens: int, profiled: bool) -> dict:
    """Paths 12, 14 and 15: one dense family (gemma-2b, starcoder2-3b,
    minicpm-2b), gear_kcvt4, monolithic prefill, dense layout: every request
    ``OK`` with its full budget of in-vocab tokens, exactly ``layers``
    ``flash_prefill`` launches per prefill and ``gear_decode`` launches per
    decode step (the decode regime: G query rows per row up to
    ``DECODE_ROWS``), no other kernel; request 0's live layer-0
    ``flash_prefill`` call (kv_repeat G) and the live layer-0 decode step
    held against their plain versions and timed; with ``profiled``, profiler
    windows over one prefill and 8 decode steps (path 20 only: the windows
    cost more of the run's time than the rest of a path)."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    G = cfg.num_heads // cfg.num_kv_heads
    if G > gd.DECODE_ROWS:
        fail(f"{cfg.name}: G = {G} is past the decode regime's {gd.DECODE_ROWS} rows")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    # request 0's layer-0 attention; layer 0 of decode step 20 (all 4 slots live)
    caps = {"flash_prefill": Capture(ops, "flash_prefill", 0),
            "gear_decode": Capture(ops, "gear_decode", 20 * layers)}
    summary = drive(eng, cfg, requests(cfg), list(caps.values()), new_tokens=new_tokens)
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill": N_REQUESTS * layers, "gear_decode": steps * layers}
    others = {k: n for k, n in launches.items() if k not in want and n}
    if {k: launches[k] for k in want} != want or others:
        fail(f"{cfg.name} launches {launches} != {want} and no other kernel")
    print(f"  per prefill {layers} flash_prefill (kv_repeat {G}), per decode step {layers} "
          f"gear_decode ({launches['gear_decode']} = {steps} x {layers})")
    flash_live(caps["flash_prefill"], f"flash_prefill live {cfg.name} layer-0 call", flush,
               reports["flash_prefill"], suffix)
    c = caps["gear_decode"]
    _, Gq, Dh = c.args[0].shape
    if (Gq, Dh) != (G, cfg.head_dim):
        fail(f"the captured gear_decode call has q {tuple(c.args[0].shape)}")
    print(f"  live {cfg.name} layer-0 step: q {tuple(c.args[0].shape)} (the decode regime), "
          f"n_comp per slot {[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep = reports["gear_decode"]
    rep[f"ms{suffix}_live"], rep[f"plain_ms{suffix}_live"], rep[f"bound_ms{suffix}_live"], _ = \
        live_check(c, gear_decode_ref, f"gear_decode live {cfg.name} decode step (G = {G}, "
                   f"Dh = {Dh})", flush, rep, decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    record_launches(reports, path, launches)
    summary["layers"] = layers
    if profiled:
        profile(eng, cfg, HERE / "build" / "profile", path)
    return summary


def serving_gemma_paged(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 13: gemma-2b, gear_kivi2 (4 V stat groups at head_dim 256),
    streaming prefill into a paged pool of two thirds of the dense pages:
    per prefill ``layers`` ``flash_prefill_block`` (kv_repeat 8), history
    and 2 x ``layers`` ``gear_compress`` launches ([64, 256] tiles), no
    ``flash_prefill``; ``layers`` ``gear_decode_paged`` per decode step; the
    live layer-0 K and V compression events bit for bit, the in-flight
    blocks, the history call and a paged step held against their plain
    versions and timed."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref, gear_decode_paged_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kivi2")
    dense_pages = B_SERVE * (CAP_SERVE // pol.buffer_size)
    pool_pages = dense_pages * 2 // 3 + 1
    eng = Engine(model, params, EngineConfig(
        batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming", layout="paged",
        pool_pages=pool_pages), device=DEV)
    prompts = requests(cfg)
    print(f"  pool: {pool_pages - 1} allocatable pages of {eng.pool.page_bytes / 1e6:.3f} MB "
          f"(the dense layout holds {dense_pages})")
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", 0),
            "gear_decode": Capture(ops, "gear_decode_history", 0),
            "gear_decode_paged": Capture(ops, "gear_decode_paged", 10 * layers)}
    rec = watch_prefills(eng, keep_index=-1)
    summary = drive(eng, cfg, prompts, list(caps.values()), new_tokens=FAMILY_TOKENS)
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill_block": layers, "gear_decode": layers, "gear_compress": 2 * layers,
            "flash_prefill": 0}
    for i, got_all in enumerate(rec["launches"]):
        got = {name: got_all[name] for name in want}
        if got != want:
            fail(f"gemma-2b streaming prefill {i} launched {got} != {want}")
    if launches["gear_decode_paged"] != steps * layers:
        fail(f"gear_decode_paged launches {launches['gear_decode_paged']} != {steps} steps x "
             f"{layers}")
    print(f"  per prefill: {want}; per decode step: {layers} gear_decode_paged; "
          f"{summary['waited_for_pages']} requests waited for pages over "
          f"{summary['page_wait_steps']} decode steps; pool {summary['pool']}")
    eng.pool.check()
    c = caps["gear_compress"]
    rep = reports["gear_compress"]
    for index, kind, scheme in ((0, "K", "per_channel"), (1, "V", "per_token")):
        (x, *_), kw = c.seen[index]
        print(f"  live gemma-2b gear_compress {kind} call: {tuple(x.shape)} tiles, {kw}")
        if kw["scheme"] != scheme or tuple(x.shape[1:]) != (64, cfg.head_dim):
            fail(f"gemma-2b gear_compress call {index} is not the {kind} event on [64, "
                 f"{cfg.head_dim}] tiles ({kw['scheme']}, {tuple(x.shape)})")
        label = f"live gemma-2b layer-0 {kind} event ([64, {x.shape[-1]}] tiles)"
        compress_check(x, kw, label, rep)
        row = compress_time(x, kw, label, flush, rep)
        key = "_gemma_k" if kind == "K" else "_gemma_v"
        rep.update({f"ms{key}": row["ms_c1"], f"plain_ms{key}": row["plain_ms"],
                    f"bound_ms{key}": row["bound_ms"]})
    c = caps["flash_prefill_block"]
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live gemma-2b layer-0 "
                      f"blocks (q {tuple(c.args[0].shape)}, kv_repeat {c.kwargs['kv_repeat']})",
                      flush, reports["flash_prefill_block"], library=True)
    reports["flash_prefill_block"].update(
        ms_gemma=row["ms_c1"], plain_ms_gemma=row["plain_ms"], bound_ms_gemma=row["bound_ms"],
        library_ms_gemma=row["library_ms"])
    c = caps["gear_decode"]
    BH, NB, R, Dh = c.args[0].shape
    gv = c.args[5].shape[-1]
    print(f"  live gemma-2b history call: q {tuple(c.args[0].shape)}, {gv} V stat groups, "
          f"extents {list(c.args[7])}")
    if gv != 4 or Dh != 256:
        fail(f"the captured history call is not gear_kivi2 at head_dim 256 ({gv} groups, Dh {Dh})")
    rep = reports["gear_decode"]
    (rep["ms_history_gemma"], rep["plain_ms_history_gemma"], rep["bound_ms_history_gemma"],
     _) = live_check(c, gear_decode_history_ref, f"gear_decode_history live gemma-2b layer-0 "
                     f"history ({NB} blocks x {R} query rows, Dh {Dh}, gv {gv})", flush, rep,
                     history_call_bytes_flops,
                     rows_of=lambda a: (torch.as_tensor(list(a[7]), device=DEV) > 0)[
                         None, :, None].expand(BH, NB, R), ops_rate=BF16_FLOPS)
    c = caps["gear_decode_paged"]
    rep = reports["gear_decode_paged"]
    print(f"  live gemma-2b paged layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep["ms_gemma"], rep["plain_ms_gemma"], rep["bound_ms_gemma"], _ = live_check(
        c, gear_decode_paged_ref, "gear_decode_paged live gemma-2b decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    record_launches(reports, "gemma_streaming_paged", launches)
    summary.update(layers=layers, prefill_ms_by_admission=rec["ms"][:N_REQUESTS])
    return summary


# ---------------------------------------------------------------------------
# paths 16-18: gemma3-12b and paligemma-3b (ROADMAP queue 1, items 8.4-8.5)


GEMMA3_LENGTHS = (1100, 1900)   # paths 16-17: raw prompt lengths, past the 1024-token window
GEMMA3_CAP = 2048
GEMMA3_TOKENS = 16              # new tokens per request on paths 16-18
VLM_PROMPT = 600                # path 18a: text tokens behind the 256 image rows
VLM_CAP = 1280                  # path 18: path 1's prompts + 256 image positions + 16


def gemma3_requests(cfg) -> list:
    """Paths 16-17's 8 prompts: raw lengths drawn from 1,100-1,900 and token
    ids, numpy seed 0."""
    rng = np.random.RandomState(0)
    lengths = rng.randint(GEMMA3_LENGTHS[0], GEMMA3_LENGTHS[1] + 1, size=N_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


def kinds_of(cfg) -> tuple:
    """(local layers, global layers) of a model."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    return kinds.count("local"), kinds.count("global")


def serving_gemma3(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 16: gemma3-12b, gear_kcvt4, monolithic prefill, dense layout,
    batch 4, capacity 2048, 8 requests of 1,100-1,900 tokens: every request
    ``OK``; per prefill one ``flash_prefill`` per layer (the 40 local ones
    with window 1024), per decode step exactly one ``gear_decode`` per global
    layer (8; the local rings decode through the portable ``cache.attend``)
    and no other kernel; request 0's live layer-0 call (local, S > 1024)
    and a live global decode step (G 2, Dh 256) held against their plain
    versions and timed, the first beside SDPA with the window as a mask;
    profiler windows over one 1,100-token prefill and 8 decode steps."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    n_local, n_global = kinds_of(cfg)
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=GEMMA3_CAP,
                                             policy=named_policy("gear_kcvt4")), device=DEV)
    # request 0's layer 0 (local); the first global layer of decode step 10
    caps = {"flash_prefill": Capture(ops, "flash_prefill", 0),
            "gear_decode": Capture(ops, "gear_decode", 10 * n_global)}
    rec = watch_prefills(eng, keep_index=-1)
    summary = drive(eng, cfg, gemma3_requests(cfg), list(caps.values()),
                    new_tokens=GEMMA3_TOKENS)
    launches, steps = summary["launches"], summary["decode_steps"]
    for i, got in enumerate(rec["launches"]):
        if {k: n for k, n in got.items() if n} != {"flash_prefill": layers}:
            fail(f"gemma3 prefill {i} launched {got}, not {layers} flash_prefill alone")
    want = {"flash_prefill": N_REQUESTS * layers, "gear_decode": steps * n_global}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"gemma3 launches {launches} != {want} and no other kernel")
    print(f"  per prefill {layers} flash_prefill ({n_local} local with window "
          f"{cfg.local_window}), per decode step {n_global} gear_decode "
          f"({launches['gear_decode']} = {steps} x {n_global})")
    c = caps["flash_prefill"]
    if c.kwargs.get("window") != cfg.local_window or c.args[0].shape[1] <= cfg.local_window:
        fail(f"the captured flash_prefill call is not a local layer past its window: "
             f"{c.kwargs}, S {c.args[0].shape[1]}")
    flash_live(c, "flash_prefill live gemma3-12b local layer-0 call", flush,
               reports["flash_prefill"], "_gemma3_local")
    c = caps["gear_decode"]
    _, Gq, Dh = c.args[0].shape
    print(f"  live gemma3-12b global layer-5 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    if (Gq, Dh) != (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim):
        fail(f"the captured gear_decode call has q {tuple(c.args[0].shape)}")
    rep = reports["gear_decode"]
    rep["ms_gemma3_live"], rep["plain_ms_gemma3_live"], rep["bound_ms_gemma3_live"], _ = \
        live_check(c, gear_decode_ref, f"gear_decode live gemma3-12b decode step (G = {Gq}, "
                   f"Dh = {Dh})", flush, rep, decode_call_bytes_flops,
                   rows_of=lambda a: a[7] > 0)
    record_launches(reports, "gemma3_dense", launches)
    summary.update(layers=layers, prefill_ms_by_admission=rec["ms"][:N_REQUESTS])
    # prompts past the window, so the profiled prefill and steps wrap the rings
    profile(eng, cfg, HERE / "build" / "profile", "gemma3_dense", prompt_len=GEMMA3_LENGTHS[0])
    return summary


def serving_gemma3_paged(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 17: the same gemma3-12b, streaming prefill into a paged pool of
    two thirds of the dense pages, the first 4 of path 16's requests: 8
    pooled global layers beside 40 dense rings, a clean audit, tokens bit
    for bit those of a dense streaming engine; per prefill a windowed
    ``flash_prefill`` on each local layer (their monolithic fallback) and
    one ``flash_prefill_block``, one history and two ``gear_compress``
    launches ([64, 256] tiles, the live K and V events bit for bit, then timed)
    on each global layer; per decode step one ``gear_decode_paged`` per global
    layer."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.serving.engine import Engine, EngineConfig

    n_local, n_global = kinds_of(cfg)
    pol = named_policy("gear_kcvt4")
    dense_pages = B_SERVE * (GEMMA3_CAP // pol.buffer_size)
    pool_pages = dense_pages * 2 // 3 + 1
    ecfg = EngineConfig(batch=B_SERVE, capacity=GEMMA3_CAP, policy=pol, prefill_mode="streaming",
                        layout="paged", pool_pages=pool_pages)
    eng = Engine(model, params, ecfg, device=DEV)
    prompts = gemma3_requests(cfg)[:4]
    caches = eng.init_caches()
    pooled = sum(isinstance(c, cache_lib.PagedGEARLayerCache) for c in caches)
    rings = sum(isinstance(c, cache_lib.WindowLayerCache) for c in caches)
    del caches
    print(f"  pool: {pool_pages - 1} allocatable pages of {eng.pool.page_bytes / 1e6:.3f} MB "
          f"(the dense layout holds {dense_pages}); {pooled} pooled layers, {rings} dense rings")
    if (pooled, rings) != (n_global, n_local):
        fail(f"gemma3 paged tree: {pooled} pooled layers and {rings} rings, not {n_global} and "
             f"{n_local}")
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1)}
    rec = watch_prefills(eng, keep_index=-1)
    keep = {}
    summary = drive(eng, cfg, prompts, list(caps.values()), new_tokens=GEMMA3_TOKENS, keep=keep)
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill": n_local, "flash_prefill_block": n_global, "gear_decode": n_global,
            "gear_compress": 2 * n_global}
    for i, got in enumerate(rec["launches"]):
        if {k: n for k, n in got.items() if n} != want:
            fail(f"gemma3 streaming prefill {i} launched {got} != {want}")
    if launches["gear_decode_paged"] != steps * n_global:
        fail(f"gear_decode_paged launches {launches['gear_decode_paged']} != {steps} steps x "
             f"{n_global}")
    eng.pool.check()
    audit = eng.audit()
    if not audit["ok"]:
        fail(f"gemma3 paged audit: {audit['issues']}")
    print(f"  per prefill: {want}; per decode step: {n_global} gear_decode_paged; "
          f"{summary['waited_for_pages']} requests waited for pages; audit clean")
    c = caps["gear_compress"]
    for index, kind in ((0, "K"), (1, "V")):
        (x, *_), kw = c.seen[index]
        if tuple(x.shape[1:]) != (64, cfg.head_dim):
            fail(f"gemma3 gear_compress call {index} is not on [64, {cfg.head_dim}] tiles")
        label = f"live gemma3-12b global layer-5 {kind} event ({x.shape[0]} [64, 256] tiles)"
        compress_check(x, kw, label, reports["gear_compress"])
        row = compress_time(x, kw, label, flush, reports["gear_compress"])
        key = "_gemma3_k" if kind == "K" else "_gemma3_v"
        reports["gear_compress"].update({f"ms{key}": row["ms_c1"], f"plain_ms{key}": row["plain_ms"],
                                         f"bound_ms{key}": row["bound_ms"]})
    dense = Engine(model, params, dc.replace(ecfg, layout="dense", pool_pages=0), device=DEV)
    dense_keep = {}
    drive(dense, cfg, prompts, [], new_tokens=GEMMA3_TOKENS, keep=dense_keep)
    differ = [rid for rid, r in keep["results"].items()
              if not np.array_equal(r.tokens, dense_keep["results"][rid].tokens)]
    print(f"  paged tokens equal the dense streaming engine's bit for bit: {not differ}")
    if differ:
        fail(f"gemma3 paged tokens differ from the dense engine's for rids {differ}")
    record_launches(reports, "gemma3_streaming_paged", launches)
    summary.update(layers=layers, prefill_ms_by_admission=rec["ms"][:len(prompts)])
    return summary


def serving_vlm(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 18: paligemma-3b, gear_kcvt4, monolithic prefill, dense layout,
    capacity 1,280: (a) one wave through ``Engine.generate``, 4 seeded
    600-token prompts behind seeded bf16 image embeddings [4, 256, 2048];
    (b) path 1's 8 prompts through ``run_continuous`` (text only, decoding
    after the 256 image positions).  In both, one ``flash_prefill`` per
    layer per prefill with the 256-position bidirectional prefix and one
    ``gear_decode`` (G 8) per layer per step, no other kernel; the wave's
    live layer-0 prefix call held against its plain version and timed beside
    SDPA with the mask."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineConfig

    P = cfg.num_prefix_tokens
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=VLM_CAP,
                                             policy=named_policy("gear_kcvt4")), device=DEV)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, size=(B_SERVE, VLM_PROMPT)).astype(np.int32),
             "img_embeds": torch.from_numpy(rng.standard_normal((B_SERVE, P, cfg.d_model))
                                            .astype(np.float32)).to(DEV, torch.bfloat16)}
    fns = kernel_fns()
    cap = Capture(ops, "flash_prefill", 0)
    try:
        for fn in fns.values():
            fn.launches = 0
        toks, stats = eng.generate(batch, GEMMA3_TOKENS)
        torch.cuda.synchronize()
        wave = {name: fn.launches for name, fn in fns.items()}
    finally:
        cap.restore()
    steps = GEMMA3_TOKENS - 1
    want = {"flash_prefill": layers, "gear_decode": steps * layers}
    if {k: n for k, n in wave.items() if n} != want:
        fail(f"paligemma wave launches {wave} != {want} and no other kernel")
    if toks.shape != (B_SERVE, GEMMA3_TOKENS) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"paligemma wave tokens {toks.shape}, ids {toks.min()}..{toks.max()}")
    q = cap.args[0]
    if cap.kwargs.get("prefix_len") != P or q.shape[1] != P + VLM_PROMPT:
        fail(f"the wave's flash_prefill call is not the {P}-position prefix over "
             f"{P + VLM_PROMPT} rows: {cap.kwargs}, {tuple(q.shape)}")
    print(f"  (a) wave: {toks.shape} tokens, prefill {stats['prefill_s'] * 1e3:.1f} ms, decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s; launches {want}")
    flash_live(cap, "flash_prefill live paligemma-3b wave layer-0 call", flush,
               reports["flash_prefill"], "_paligemma")
    first = Capture(ops, "flash_prefill", 0)
    summary = drive(eng, cfg, requests(cfg), [first], new_tokens=GEMMA3_TOKENS)
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill": N_REQUESTS * layers, "gear_decode": steps * layers}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"paligemma continuous launches {launches} != {want} and no other kernel")
    if first.kwargs.get("prefix_len") != P:
        fail(f"paligemma continuous prefill without its prefix mask: {first.kwargs}")
    print(f"  (b) continuous: per prefill {layers} flash_prefill (prefix {P}), per step "
          f"{layers} gear_decode (G {cfg.num_heads // cfg.num_kv_heads})")
    record_launches(reports, "paligemma_dense", {k: wave[k] + launches[k] for k in launches})
    summary.update(layers=layers, wave_prefill_ms=stats["prefill_s"] * 1e3,
                   wave_decode_tok_per_s=stats["decode_tok_per_s"],
                   wave_cache_bytes=stats["cache_bytes"])
    return summary


# ---------------------------------------------------------------------------
# paths 19-22: musicgen-medium and the MoE pair (ROADMAP queue 1, items 8.6-8.7)


MUSIC_FRAMES = 620              # path 19: frames a prompt, 44 in the buffer after prefill
MUSIC_CAP = 704                 # path 19: 11 chunks of 64, so each row closes one in decode
MUSIC_TOKENS = 32               # path 19: new frames a row
MOE_LAYERS = 8                  # paths 20-22: depth; the weights of ~15 layers fill the card
MOE_TOKENS = 16                 # paths 20-22: new tokens a request


def serving_audio(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 19: musicgen-medium, gear_kcvt4, monolithic prefill, dense
    layout, capacity 704: one wave through ``Engine.generate`` (the
    reference's only audio entry point) of 4 seeded prompts of 620 frames x
    4 codebook ids and 32 new frames: frames [4, 32, 4] in vocab, exactly
    ``layers`` ``flash_prefill`` launches (BHq 96, Dh 64) for the wave's
    prefill and ``layers`` ``gear_decode`` (G 1, Dh 64) per step, no other
    kernel; the live layer-0 prefill call held against its plain version
    and timed beside SDPA, a live decode step against its plain version."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    K = cfg.num_codebooks
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=MUSIC_CAP,
                                             policy=named_policy("gear_kcvt4")), device=DEV)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               size=(B_SERVE, MUSIC_FRAMES, K)).astype(np.int32)
    fns = kernel_fns()
    steps = MUSIC_TOKENS - 1
    # layer 0 of the prefill; layer 0 of decode step 20 (its rows past a chunk close)
    caps = [Capture(ops, "flash_prefill", 0), Capture(ops, "gear_decode", 20 * layers)]
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in fns.values():
            fn.launches = 0
        frames, stats = eng.generate({"tokens": prompts}, MUSIC_TOKENS)
        torch.cuda.synchronize()
        wave = {name: fn.launches for name, fn in fns.items()}
    finally:
        for c in caps:
            c.restore()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_prefill": layers, "gear_decode": steps * layers}
    if {k: n for k, n in wave.items() if n} != want:
        fail(f"musicgen wave launches {wave} != {want} and no other kernel")
    if frames.shape != (B_SERVE, MUSIC_TOKENS, K) or frames.min() < 0 \
            or frames.max() >= cfg.vocab_size:
        fail(f"musicgen frames {frames.shape}, ids {frames.min()}..{frames.max()}")
    print(f"  frames {frames.shape} in vocab; prefill {stats['prefill_s'] * 1e3:.1f} ms for 4 x "
          f"{MUSIC_FRAMES} frames, decode {stats['decode_tok_per_s']:.1f} frames/s "
          f"({stats['decode_tok_per_s'] * K:.1f} codebook ids/s), peak memory {peak / 1e9:.2f} "
          f"GB, cache {stats['cache_bytes'] / 1e6:.1f} MB; launches {want}")
    flash_live(caps[0], "flash_prefill live musicgen-medium wave layer-0 call", flush,
               reports["flash_prefill"], "_musicgen")
    c = caps[1]
    print(f"  live musicgen layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep = reports["gear_decode"]
    rep["ms_musicgen_live"], rep["plain_ms_musicgen_live"], rep["bound_ms_musicgen_live"], _ = \
        live_check(c, gear_decode_ref, "gear_decode live musicgen-medium decode step (G = 1, "
                   "Dh = 64)", flush, rep, decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    record_launches(reports, "musicgen_wave", wave)
    return {"layers": layers, "launches": wave, "prefill_ms": stats["prefill_s"] * 1e3,
            "decode_frames_per_s": stats["decode_tok_per_s"], "decode_s": stats["decode_s"],
            "cache_bytes": stats["cache_bytes"], "max_memory_allocated_gb": peak / 1e9}


def watch_routing():
    """Wrap ``models.moe.route``: every call's row count and kept mask, in
    call order (counted after the run, so no call waits for the device)."""
    from repro_torch.models import moe as moe_lib

    real = moe_lib.route
    seen = []

    def spy(cfg, router, xt):
        r = real(cfg, router, xt)
        seen.append((xt.shape[0], r.capacity, r.keep))
        return r

    moe_lib.route = spy
    return seen, lambda: setattr(moe_lib, "route", real)


def dropped_pairs(seen: list, layers: int) -> tuple:
    """Per prefill (admission order) the ``(token, k)`` pairs its layers
    dropped and the capacity it ran at, and the decode steps' drops."""
    prefill = [s for s in seen if s[0] > B_SERVE]
    per = [(sum(int((~keep).sum()) for _, _, keep in prefill[i:i + layers]), prefill[i][1],
            prefill[i][0]) for i in range(0, len(prefill), layers)]
    decode = sum(int((~keep).sum()) for T, _, keep in seen if T <= B_SERVE)
    return per, decode


def moe_floor(params, cfg, layers: int) -> dict:
    """The byte floor of one decode step: every expert's weights are read
    (the capacity dispatch runs each expert on its C = 8 slots at batch 4),
    and with them the attention, norms, router and head (not the embedding:
    4 rows of it)."""
    expert = sum(p.numel() * p.element_size() for blk in params.blocks
                 for name, p in blk.moe.named_parameters() if name != "router")
    step = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
               if name != "embed")
    return {"expert_bytes": expert, "step_bytes": step,
            "expert_floor_ms": expert / HBM_BYTES_PER_S * 1e3,
            "step_floor_ms": step / HBM_BYTES_PER_S * 1e3,
            "floor_tok_per_s": B_SERVE / (step / HBM_BYTES_PER_S)}


def serving_moe(model, params, cfg, layers: int, flush, reports: dict, path: str,
                suffix: str, profiled: bool) -> dict:
    """Paths 20-21: an MoE model (qwen3-moe-235b-a22b: kv_repeat 16, G 16;
    llama4-scout-17b-a16e: kv_repeat 5, G 5, top-1 with the shared expert)
    at published widths and ``layers`` of its depth, as path 14 with path
    1's traffic and 16 new tokens: per prefill ``layers`` ``flash_prefill``,
    per step ``layers`` ``gear_decode``, no other kernel; each prefill's
    dropped ``(token, k)`` pairs printed, and decode tok/s beside the step's
    byte floor; with ``profiled``, profiler windows over one prefill and 8
    decode steps (is the step set by its bytes or by its launches?)."""
    seen, restore = watch_routing()
    try:
        summary = serving_family(model, params, cfg, layers, flush, reports, path, suffix,
                                 MOE_TOKENS, profiled)
    finally:
        restore()
    per, decode = dropped_pairs(seen, layers)
    per = per[:N_REQUESTS]                    # drive's; a profiler window's prefills follow
    if len(per) != N_REQUESTS or decode:
        fail(f"{cfg.name}: {len(per)} prefills routed, {decode} pairs dropped in decode")
    print(f"  dropped (token, k) pairs per prefill over {layers} layers (capacity at its "
          f"length): {[f'{n} (C {c} at {t})' for n, c, t in per]}; decode steps drop none")
    floor = moe_floor(params, cfg, layers)
    print(f"  decode {summary['decode_tok_per_s']:.1f} tok/s against the byte floor "
          f"{floor['floor_tok_per_s']:.1f} tok/s: a step reads {floor['step_bytes'] / 1e9:.2f} GB "
          f"({floor['expert_bytes'] / 1e9:.2f} GB of experts), >= {floor['step_floor_ms']:.2f} ms "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    summary.update(floor, dropped_per_prefill=[n for n, _, _ in per],
                   capacity_per_prefill=[c for _, c, _ in per])
    return summary


def moe_paged_pool(cfg, prompts: list, nb: int) -> int:
    """Path 22's pool: two thirds of the pages the requests' lifetimes hold
    (prompt + new tokens - 1 each), plus the zero page, so that the last
    request waits for pages."""
    from repro_torch.serving.pagedpool import pages_needed

    need = sum(pages_needed(len(p) + MOE_TOKENS - 1, nb) for p in prompts)
    return need * 2 // 3 + 1


def serving_moe_paged(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 22: path 21's llama4-scout with streaming prefill into a paged
    pool of two thirds of the 4 requests' lifetime pages, path 1's first 4
    requests: a request waits for pages, a clean pool check and audit, per
    prefill ``layers`` ``flash_prefill_block`` (kv_repeat 5), history and 2 x
    ``layers`` ``gear_compress`` launches and no ``flash_prefill``, per step
    ``layers`` ``gear_decode_paged``; the live K and V compression events bit
    for bit, the in-flight blocks, the history call and a paged step held
    against their plain versions and timed; greedy tokens equal to a dense
    streaming engine's bit for bit."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref, gear_decode_paged_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    prompts = requests(cfg)[:4]
    pool_pages = moe_paged_pool(cfg, prompts, pol.buffer_size)
    ecfg = EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming",
                        layout="paged", pool_pages=pool_pages)
    eng = Engine(model, params, ecfg, device=DEV)
    print(f"  pool: {pool_pages - 1} allocatable pages of {eng.pool.page_bytes / 1e6:.3f} MB "
          f"(the 4 requests' lifetimes hold {(pool_pages - 1) * 3 // 2}; dense layout "
          f"{B_SERVE * (CAP_SERVE // pol.buffer_size)})")
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", 0),
            "gear_decode": Capture(ops, "gear_decode_history", 0),
            "gear_decode_paged": Capture(ops, "gear_decode_paged", 10 * layers)}
    rec = watch_prefills(eng, keep_index=-1)
    seen, restore = watch_routing()
    keep = {}
    try:
        summary = drive(eng, cfg, prompts, list(caps.values()), new_tokens=MOE_TOKENS, keep=keep)
    finally:
        restore()
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill_block": layers, "gear_decode": layers, "gear_compress": 2 * layers}
    for i, got in enumerate(rec["launches"]):
        if {k: n for k, n in got.items() if n} != want:
            fail(f"{cfg.name} streaming prefill {i} launched {got} != {want}")
    if launches["gear_decode_paged"] != steps * layers:
        fail(f"gear_decode_paged launches {launches['gear_decode_paged']} != {steps} steps x "
             f"{layers}")
    if summary["waited_for_pages"] < 1:
        fail(f"{cfg.name} paged: no request waited for pages")
    eng.pool.check()
    audit = eng.audit()
    if not audit["ok"]:
        fail(f"{cfg.name} paged audit: {audit['issues']}")
    per, _ = dropped_pairs(seen, layers)
    print(f"  per prefill: {want}; per decode step: {layers} gear_decode_paged; "
          f"{summary['waited_for_pages']} requests waited for pages over "
          f"{summary['page_wait_steps']} steps; audit clean; dropped pairs per prefill "
          f"{[n for n, _, _ in per]}")
    c = caps["gear_compress"]
    rep = reports["gear_compress"]
    for index, kind, scheme in ((0, "K", "per_channel"), (1, "V", "per_token")):
        (x, *_), kw = c.seen[index]
        if kw["scheme"] != scheme or tuple(x.shape[1:]) != (64, cfg.head_dim):
            fail(f"{cfg.name} gear_compress call {index} is not the {kind} event on [64, "
                 f"{cfg.head_dim}] tiles ({kw['scheme']}, {tuple(x.shape)})")
        label = f"live llama4-scout layer-0 {kind} event ({x.shape[0]} [64, {x.shape[-1]}] tiles)"
        compress_check(x, kw, label, rep)
        row = compress_time(x, kw, label, flush, rep)
        key = "_llama4_k" if kind == "K" else "_llama4_v"
        rep.update({f"ms{key}": row["ms_c1"], f"plain_ms{key}": row["plain_ms"],
                    f"bound_ms{key}": row["bound_ms"]})
    c = caps["flash_prefill_block"]
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live llama4-scout layer-0 "
                      f"blocks (q {tuple(c.args[0].shape)}, kv_repeat {c.kwargs['kv_repeat']})",
                      flush, reports["flash_prefill_block"], library=True)
    reports["flash_prefill_block"].update(
        ms_llama4=row["ms_c1"], plain_ms_llama4=row["plain_ms"], bound_ms_llama4=row["bound_ms"],
        library_ms_llama4=row["library_ms"])
    c = caps["gear_decode"]
    BH, NB, R, Dh = c.args[0].shape
    rep = reports["gear_decode"]
    (rep["ms_history_llama4"], rep["plain_ms_history_llama4"], rep["bound_ms_history_llama4"],
     _) = live_check(c, gear_decode_history_ref, f"gear_decode_history live llama4-scout "
                     f"layer-0 history ({NB} blocks x {R} query rows, Dh {Dh})", flush, rep,
                     history_call_bytes_flops,
                     rows_of=lambda a: (torch.as_tensor(list(a[7]), device=DEV) > 0)[
                         None, :, None].expand(BH, NB, R), ops_rate=BF16_FLOPS)
    c = caps["gear_decode_paged"]
    rep = reports["gear_decode_paged"]
    print(f"  live llama4-scout paged layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep["ms_llama4"], rep["plain_ms_llama4"], rep["bound_ms_llama4"], _ = live_check(
        c, gear_decode_paged_ref, "gear_decode_paged live llama4-scout decode step (G = 5)",
        flush, rep, decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    dense = Engine(model, params, dc.replace(ecfg, layout="dense", pool_pages=0), device=DEV)
    dense_keep = {}
    drive(dense, cfg, prompts, [], new_tokens=MOE_TOKENS, keep=dense_keep)
    differ = [rid for rid, r in keep["results"].items()
              if not np.array_equal(r.tokens, dense_keep["results"][rid].tokens)]
    print(f"  paged tokens equal the dense streaming engine's bit for bit: {not differ}")
    if differ:
        fail(f"{cfg.name} paged tokens differ from the dense engine's for rids {differ}")
    record_launches(reports, "llama4_streaming_paged", launches)
    summary.update(layers=layers, prefill_ms_by_admission=rec["ms"][:len(prompts)],
                   dropped_per_prefill=[n for n, _, _ in per])
    return summary


def profile(eng, cfg, out_dir: pathlib.Path, tag: str, prompt_len: int = 640) -> None:
    """Where the time goes: ``torch.profiler`` over one ``prompt_len``-token
    prefill and over 8 decode steps of 4 live slots (after warm-up).  Prints
    each window's wall time, device-busy share (summed kernel time / wall)
    and top operators by device time; full tables go to ``out_dir``."""
    rng = np.random.RandomState(1)
    view = eng.new_view()
    prompts = [rng.randint(0, cfg.vocab_size, size=prompt_len).astype(np.int32)[None]
               for _ in range(4)]
    reserve = prompt_len + 16                                # paged: 11 steps' pages
    for s, p in enumerate(prompts):
        view.prefill_slot({"tokens": p}, s, reserve_tokens=reserve)
    pos = np.full(4, prompt_len, np.int32)
    tok = np.zeros((4, 1), np.int32)
    for _ in range(3):                                       # warm-up steps
        view.decode({"tokens": tok}, pos)
        pos += 1
    torch.cuda.synchronize()
    profile_window(lambda: view.prefill_slot({"tokens": prompts[0]}, 0, reserve_tokens=reserve),
                   out_dir, tag, "prefill")
    profile_window(lambda: [view.decode({"tokens": tok}, pos + i) for i in range(8)],
                   out_dir, tag, "decode")


def profile_window(fn, out_dir: pathlib.Path, tag: str, name: str) -> None:
    """One ``torch.profiler`` window over ``fn``: its wall time, device-busy
    share (summed kernel time / wall), launches and top operators by device
    and host time; the full table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n_launch = sum(e.count for e in kernels)
    (out_dir / f"profile_{tag}_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40) + "\n"
        + events.table(sort_by="cpu_time_total", row_limit=40))
    print(f"  profile {tag} {name}: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}%), {n_launch} kernel launches, profiler on")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.3f} ms x{e.count}")
    for e in sorted(events, key=lambda e: -e.cpu_time_total)[:12]:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            print(f"    host {e.key[:65]:65s} {e.cpu_time_total / 1e3:9.3f} ms x{e.count}")
    print(f"  profiler table in {out_dir / f'profile_{tag}_{name}.txt'}")


# ---------------------------------------------------------------------------
# training (paths 23-24) and adaptive rank


TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 512, 2, 8
TRAIN_LOSS_ATOL = 1e-2         # one step, card against the CPU port (the CPU tests' bound)
TRAIN_STEP_COS = 0.98          # the update of each leaf of >= 1,000 elements, card against CPU
# path 24's smoke configs; rwkv6-3b is held on its gradients at the CPU
# tests' GRAD_LIMITS (relative error, cosine), not on the update's cosine
CROSS_ARCHS = ("minicpm-2b", "rwkv6-3b", "hymba-1.5b", "qwen3-moe-235b-a22b", "paligemma-3b",
               "musicgen-medium")
RWKV_GRAD_LIMITS = (0.5, 0.95)
RESTORE_ATOL = 1e-5            # 6 steps straight against 3 + restore + 3 (the reference's bound)
# adaptive / uniform relative errors, card against CPU.  Six unnormalised
# power-iteration sweeps in f32 leave the trailing columns of a 16- or
# 32-column subspace to rounding: on the CPU a one-ulp nudge of the input
# moves the errors by up to 1.4e-4 (r 8); an H100 read 2.2e-4 at r 4
ADAPTIVE_ERR_ATOL = 1e-3
# the error table's relative errors, card against the CPU port: f32 norms and
# products summed in another order, and the power iteration's trailing
# columns left to rounding as above (the CPU tests hold the CPU port to the
# reference within 1e-5)
ERROR_TABLE_ATOL = 1e-3
# benchmarks/bench_error.py's METHODS_2BIT + METHODS_4BIT
ERROR_METHODS = ("per_token_q2", "kivi2", "outlier_kivi2", "gear_l_kivi2", "gear_kivi2",
                 "per_token_q4", "kcvt4", "kivi4", "gear_l_kcvt4", "gear_kcvt4")
ERROR_HEAD_DIMS = (80, 96)    # approx_error at head dims no shipped config has


def zero_launches() -> dict:
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    return fns


def training(flush, reports: dict, arch: str = TRAIN_ARCH, path: str = "train_full") -> dict:
    """Paths 23, 25 and 26: ``arch`` at its published widths and depth
    (random f32 master weights from a seeded generator), the config's
    schedule (warmup 1 of 8 steps), remat per layer with the ``dots``
    policy, batches of 4 x 512 tokens from ``data.synthetic`` in 2
    microbatches, 8 steps of ``make_train_step``, no checkpoint (one would
    write tens of GB).  Every step's loss and grad norm must be finite and
    positive, the last step's loss below the first's.  A model without a
    scan (path 23) must launch no kernel; an RWKV6 or hybrid model (paths
    25-26) must launch ``linear_scan_chunked`` exactly 2 x layers x
    microbatches times a step (the forward, and ``dots`` remat's recompute
    of each layer's forward in the backward) and ``linear_scan_chunked_bwd``
    layers x microbatches times, and no other kernel; its first live
    backward call is held against the plain backward and timed.  Prints the
    step time, tokens/s, peak memory, and the share of the card's dense bf16
    peak that 8 N tokens per step reach (6 N forward and backward, 2 N the
    remat's recompute); then one more step under a CUDA-only profiler
    (``kernel_breakdown``): its summed kernel time against an unprofiled
    step (the device's busy share) and the leading kernels."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.kernels import linear_scan_kernel as lsk
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import is_hybrid
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.state import RunConfig, init_train_state

    cfg = get_config(arch)
    scans = cfg.rwkv or is_hybrid(cfg)
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=DEV, dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name} (d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_layers} layers): {n_params / 1e9:.3f} B "
          f"f32 parameters, init {time.perf_counter() - t0:.1f} s")
    run = RunConfig(total_steps=TRAIN_STEPS, warmup_steps=1, microbatches=TRAIN_MICRO,
                    remat=True, remat_policy="dots", ckpt_every=0, log_every=1)
    state = init_train_state(params, run)
    step = make_train_step(model, run)
    dc_ = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH)
    batches = [make_batch(dc_, cfg, s, DEV) for s in range(TRAIN_STEPS)]
    fns = zero_launches()
    # the last layer's backward scan of step 0's first microbatch
    cap = Capture(lsk, "linear_scan_chunked_bwd", 0) if scans else None
    rows = []
    try:
        for s in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = step(state, batches[s])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            m = {k: float(v) for k, v in met.items()}
            rows.append(dict(m, ms=ms))
            print(f"  step {s}: loss {m['loss']:.4f} (ce {m['ce']:.4f}) lr {m['lr']:.3e} "
                  f"grad_norm {m['grad_norm']:.4f}, {ms:.1f} ms")
        launches = {name: fn.launches for name, fn in fns.items()}
    finally:
        if cap is not None:
            cap.restore()
    per_step = TRAIN_MICRO * cfg.num_layers if scans else 0
    want = ({"linear_scan_chunked": 2 * per_step * TRAIN_STEPS,
             "linear_scan_chunked_bwd": per_step * TRAIN_STEPS} if scans else {})
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"training {cfg.name}: kernel launches {launches}, expected {want} (others 0)")
    for r in rows:
        if not all(np.isfinite(r[k]) and r[k] > 0 for k in ("loss", "grad_norm")):
            fail(f"training: a loss or grad norm is not finite and positive: {rows}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        fail(f"training: the last loss {rows[-1]['loss']} is not below the first "
             f"{rows[0]['loss']}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))     # step 0 warms the allocator
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = 8 * n_params * tokens
    share = flops / (step_ms / 1e3) / BF16_FLOPS
    roof = train_roofline(cfg, n_params, step_ms)
    print(f"  kernel launches over the {TRAIN_STEPS} steps: {launches} (expected "
          f"{want or 'all 0'}" + (f": {2 * per_step} forward and {per_step} backward scans a "
                                  f"step" if scans else "") + ")")
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params}
    if scans:
        rep = reports["linear_scan_chunked_bwd"]
        r, k, v, lw, u = cap.args
        print(f"  live backward scan: r {tuple(r.shape)}, log_w {tuple(lw.shape)}, "
              f"{ {n: x for n, x in cap.kwargs.items() if not isinstance(x, torch.Tensor)} }")
        live = scan_bwd_check(cap.real, tuple(cap.args), cap.kwargs,
                              f"linear_scan_chunked_bwd live {cfg.name} backward scan", flush,
                              rep)
        out.update(zip(("scan_bwd_ms", "scan_bwd_plain_ms", "scan_bwd_bound_ms",
                        "scan_bwd_bound_by"), live))
        rep.setdefault("launches_by_path", {})[path] = launches["linear_scan_chunked_bwd"]
        reports["linear_scan_chunked"]["launches_by_path"][path] = launches["linear_scan_chunked"]
    holder = [state]

    def one_more():
        holder[0], _ = step(holder[0], batches[0])

    kernels = kernel_breakdown(one_more, 1, flush)
    state = holder[0]
    busy_s = sum(kernels.values()) / 1e3
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {name[:80]:80s} {ms:9.3f} ms")
    print(f"  step {step_ms:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
          f"{rows[0]['ms']:.1f} ms), {tokens / (step_ms / 1e3):.0f} tokens/s, peak memory "
          f"{peak:.2f} GB, 8 N tokens = {flops / 1e12:.1f} TFLOP a step: {share * 100:.2f}% of "
          f"the dense bf16 peak; a profiled step's kernels {busy_s * 1e3:.1f} ms = "
          f"{busy_s * 1e3 / step_ms * 100:.1f}% of an unprofiled step; "
          f"{smi()}")
    print(f"  {roofline_text(roof)}")
    del state, params, step, batches, holder
    gc.collect()
    torch.cuda.empty_cache()
    return out | {"tokens_per_step": tokens, "steps": rows, "step_ms": step_ms,
                  "tokens_per_s": tokens / (step_ms / 1e3), "peak_gb": peak,
                  "bf16_peak_share": share, "launches": launches,
                  "device_ms_per_step": busy_s * 1e3, "roofline": roof, "card": smi()}


def train_roofline(cfg, n_params: int, step_ms: float) -> dict:
    """``perf.roofline``'s row for one train step of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens on one card: executed operations 8 N D (forward
    and backward 6 N D, the ``dots`` remat's recompute 2 N D; N the counted
    parameters), bytes AdamW's floor (p, g, m and v read, p, m and v
    written: 28 B a parameter), no collective, and ``model_flops`` 6 N D (N
    the config's analytic ``active_param_count``); beside it the measured
    shares of the dense bf16 peak: 6 N D (``model_flops``) and 8 N D a
    step over the step's time."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.perf.roofline import model_flops, roofline

    tokens = TRAIN_BATCH * TRAIN_SEQ
    shape = ShapeConfig("chip_smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    useful = model_flops(cfg, shape)
    row = roofline(8.0 * n_params * tokens, 28.0 * n_params, 0.0, 1, useful).row()
    sec = step_ms / 1e3
    return row | {"share_6nd": useful / sec / HW["peak_flops"],
                  "share_8n": 8.0 * n_params * tokens / sec / HW["peak_flops"]}


def roofline_text(roof: dict) -> str:
    return (f"roofline (perf.roofline, one card): compute {roof['compute_s'] * 1e3:.1f} ms, "
            f"memory {roof['memory_s'] * 1e3:.2f} ms, bound by {roof['bottleneck']}; "
            f"model_flops 6 N D = {roof['model_flops'] / 1e12:.2f} TFLOP (flops_eff "
            f"{roof['flops_eff']:.3f} of 8 N D); measured share of the dense bf16 peak: "
            f"6 N D {roof['share_6nd'] * 100:.2f}%, 8 N D {roof['share_8n'] * 100:.2f}%")


def training_cross() -> dict:
    """Path 24: the smoke configs of ``CROSS_ARCHS``.  For each, one
    ``make_train_step`` on the CPU port and on the card from the same f32
    weights (seeded on the CPU, then copied) and batch: loss within
    ``TRAIN_LOSS_ATOL``, each leaf's update (of >= 1,000 elements) at cosine
    >= ``TRAIN_STEP_COS``; rwkv6-3b, whose gradient at init is
    ill-conditioned (ROADMAP standing difference m), is held instead on the
    step's gradients, every leaf within ``RWKV_GRAD_LIMITS`` (the CPU tests'
    ``GRAD_LIMITS``: relative Frobenius error, cosine).  Then, on the card,
    minicpm-2b's 6 steps of ``train_loop`` straight against 3 steps,
    ``ckpt.save``, a fresh ``train_loop`` resuming from that checkpoint and
    3 more steps (the reference's restore recipe): parameters within
    ``RESTORE_ATOL``."""
    import copy
    import tempfile

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import _accum_grads, make_train_step, train_loop
    from repro_torch.train.state import RunConfig, init_train_state

    run = RunConfig(total_steps=6, warmup_steps=0, microbatches=2, remat=True,
                    remat_policy="dots", ckpt_every=0, log_every=1)
    out = {}
    for arch in CROSS_ARCHS:
        cfg = smoke_config(arch)
        model = build_model(cfg)
        dc_ = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
        cpu_params = model.init(seed=0, device="cpu", dtype=torch.float32)
        card_params = copy.deepcopy(cpu_params).to(DEV)
        before = {n: p.detach().clone() for n, p in cpu_params.named_parameters()}
        step = make_train_step(model, run)
        loss, grads = {}, {}
        for key, dev, params in (("cpu", "cpu", cpu_params), ("cuda", DEV, card_params)):
            batch = make_batch(dc_, cfg, 0, dev)
            if arch == "rwkv6-3b":
                lo, _, g = _accum_grads(model, params.requires_grad_(True), batch, run)
                grads[key] = {n: t.detach().cpu().double() for n, t in g.items()}
                loss[key] = float(lo)
            else:
                _, met = step(init_train_state(params, run), batch)
                loss[key] = float(met["loss"])
        gap = abs(loss["cpu"] - loss["cuda"])
        if arch == "rwkv6-3b":
            rel_max, cos_min = 0.0, 1.0
            for n, a in grads["cpu"].items():
                b = grads["cuda"][n]
                nb = float(b.norm())
                rel = float((a - b).norm()) / max(nb, 1e-300)
                cos = float(a.flatten() @ b.flatten()) / max(float(a.norm()) * nb, 1e-300)
                rel_max, cos_min = max(rel_max, rel), min(cos_min, cos)
            print(f"  {arch}: one step's loss on the CPU and on the card {loss['cpu']:.6f} / "
                  f"{loss['cuda']:.6f} (gap {gap:.2e}); gradients, card against CPU: largest "
                  f"relative error {rel_max:.4f}, least cosine {cos_min:.6f} (limits "
                  f"{RWKV_GRAD_LIMITS})")
            if gap > TRAIN_LOSS_ATOL or rel_max > RWKV_GRAD_LIMITS[0] or \
                    cos_min < RWKV_GRAD_LIMITS[1]:
                fail(f"training {arch} on the card leaves the CPU port: loss gap {gap}, "
                     f"gradient rel {rel_max}, cosine {cos_min}")
            out[arch] = {"loss_cpu": loss["cpu"], "loss_cuda": loss["cuda"],
                         "grad_rel_max": rel_max, "grad_cos_min": cos_min}
            continue
        worst = 1.0
        for (n, p), (_, q) in zip(cpu_params.named_parameters(), card_params.named_parameters()):
            if p.numel() >= 1000:
                a = (p.detach() - before[n]).double().flatten()
                b = (q.detach().cpu() - before[n]).double().flatten()
                worst = min(worst, float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)))
        print(f"  {arch}: one step on the CPU and on the card: loss {loss['cpu']:.6f} / "
              f"{loss['cuda']:.6f} (gap {gap:.2e}), least update cosine {worst:.6f}")
        if gap > TRAIN_LOSS_ATOL or worst < TRAIN_STEP_COS:
            fail(f"training {arch} on the card leaves the CPU port: loss gap {gap}, "
                 f"cosine {worst}")
        out[arch] = {"loss_cpu": loss["cpu"], "loss_cuda": loss["cuda"],
                     "least_update_cos": worst}

    cfg = smoke_config(TRAIN_ARCH)
    model = build_model(cfg)
    dc_ = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    build = HERE / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        def loop(name, total):
            r = dc.replace(run, total_steps=total, warmup_steps=1,
                           ckpt_dir=str(pathlib.Path(root) / name))
            return train_loop(model, r, dc_, log_fn=lambda *_: None, device=DEV)

        straight = loop("a", 6)
        first = loop("b", 3)
        ck.save(str(pathlib.Path(root) / "b"), 3, first)
        resumed = loop("b", 6)
        diff = max(float((p.detach() - q.detach()).abs().max()) for p, q in
                   zip(straight.params.parameters(), resumed.params.parameters()))
    print(f"  {TRAIN_ARCH}: 6 steps straight against 3 + save + resume + 3 on the card: max "
          f"diff {diff:.3e} (resumed at step {resumed.step})")
    if resumed.step != 6 or diff >= RESTORE_ATOL:
        fail(f"restore: max diff {diff} (bound {RESTORE_ATOL}), step {resumed.step}")
    return out | {"restore_max_diff": diff}


def training_mesh(path23: dict) -> dict:
    """Path 27: path 23's recipe (its ``RunConfig``, weights, batches) through
    ``train_loop(..., steps=3, mesh=make_test_mesh(1, 1))``, ZeRO-1 on, one
    NCCL process: the mesh step's gathers, ZeRO-1 slices and data means over
    axes of size 1.  Its three losses and grad norms must equal path 23's
    first three bit for bit, and no kernel launches (as path 23).  Each
    step is timed around ``make_train_step``'s step (device-synchronized),
    beside path 23's; then, on the same state, a warm-up mesh step and the
    one-device and mesh steps in turns (p1, m1, m2, p2): the mesh layer's
    cost a step; peak memory over the loop; ``perf.roofline``'s row."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train import loop
    from repro_torch.train.state import RunConfig

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    mesh = make_test_mesh(1, 1)
    dc_ = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH)
    rows, real = [], loop.make_train_step

    def timed_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def run_step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t) * 1e3} |
                        {k: float(v) for k, v in met.items()})
            return state, met

        return run_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build = HERE / "build"
    build.mkdir(exist_ok=True)
    fns = zero_launches()
    loop.make_train_step = timed_step
    try:
        with tempfile.TemporaryDirectory(dir=build) as ckpt:
            # path 23's RunConfig; the checkpoint directory is fresh (ckpt_every
            # 0 writes nothing, and nothing there resumes)
            run = RunConfig(total_steps=TRAIN_STEPS, warmup_steps=1, microbatches=TRAIN_MICRO,
                            remat=True, remat_policy="dots", ckpt_every=0, log_every=1,
                            ckpt_dir=ckpt)
            state = loop.train_loop(model, run, dc_, steps=3, log_fn=lambda *_: None, mesh=mesh)
    finally:
        loop.make_train_step = real
    launches = {name: fn.launches for name, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in state.params.parameters())
    loop_steps = state.step
    # the mesh layer's cost in turns on the same state (steps 3-7): a warm-up
    # mesh step, then one-device p1, mesh m1, m2, one-device p2
    batches = [make_batch(dc_, cfg, s_, DEV) for s_ in range(3, 8)]
    steps = {"mesh": real(model, run, mesh), "one_device": real(model, run)}
    turn_ms = {"mesh": [], "one_device": []}
    for i, kind in enumerate(("mesh", "one_device", "mesh", "mesh", "one_device")):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = steps[kind](state, batches[i])
        torch.cuda.synchronize()
        if i:
            turn_ms[kind].append((time.perf_counter() - t) * 1e3)
    gap_ms = float(np.mean(turn_ms["mesh"]) - np.mean(turn_ms["one_device"]))
    print(f"  in turns (p1, m1, m2, p2) on steps 4-7: one-device {turn_ms['one_device']} ms, "
          f"mesh {turn_ms['mesh']} ms: the mesh layer costs {gap_ms:+.1f} ms a step")
    want = path23["steps"][:3]
    for i, (got, ref) in enumerate(zip(rows, want)):
        print(f"  step {i}: loss {got['loss']!r} grad_norm {got['grad_norm']!r}, "
              f"{got['ms']:.1f} ms (path 23: {ref['loss']!r} / {ref['grad_norm']!r}, "
              f"{ref['ms']:.1f} ms)")
    if len(rows) != 3 or loop_steps != 3 or any(
            (g["loss"], g["grad_norm"]) != (r["loss"], r["grad_norm"]) for g, r in zip(rows, want)):
        fail(f"path 27: the mesh step's losses / grad norms {rows} are not path 23's {want[:3]}")
    if any(launches.values()):
        fail(f"path 27: kernel launches {launches}, expected none")
    step_ms = float(np.median([r["ms"] for r in rows[1:]]))
    ref_ms = float(np.median([r["ms"] for r in want[1:3]]))
    roof = train_roofline(cfg, n_params, step_ms)
    print(f"  step {step_ms:.1f} ms (median of steps 1-2; path 23's steps 1-2 "
          f"{ref_ms:.1f} ms, path 23's median {path23['step_ms']:.1f} ms), peak memory "
          f"{peak:.2f} GB (path 23: {path23['peak_gb']:.2f} GB); {smi()}")
    print(f"  {roofline_text(roof)}")
    del state, steps, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": rows, "step_ms": step_ms, "path23_steps_1_2_ms": ref_ms,
            "turns_ms": turn_ms, "mesh_layer_ms": gap_ms,
            "peak_gb": peak, "launches": launches, "roofline": roof, "card": smi()}


PSGD_RANK, PSGD_MIN_SIZE = 8, 4096   # path 28: minicpm-2b's smoke matrices are 2,048-32,768


def training_powersgd() -> dict:
    """Path 28: PowerSGD on the pod mesh ``make_test_mesh(1, 1, pod=1)``,
    minicpm-2b's smoke config, rank 8, ``powersgd_min_size`` 4096: one mesh
    step on the card against the same step on the CPU port from the same
    weights (seeded on the CPU, then copied), batch and start matrices
    (``grad_compress.draw_inits`` draws on the CPU), under path 24's bounds
    (loss within ``TRAIN_LOSS_ATOL``, every update of >= 1,000 elements at
    cosine >= ``TRAIN_STEP_COS``), ``compressed_bytes`` above 0 on both.
    Its launcher run is in phase 40, with the others
    (:func:`train_launchers`)."""
    import copy

    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.state import RunConfig, init_train_state

    mesh = make_test_mesh(1, 1, pod=1)
    cfg = smoke_config(TRAIN_ARCH)
    model = build_model(cfg)
    run = RunConfig(total_steps=6, warmup_steps=0, microbatches=2, remat=True,
                    remat_policy="dots", ckpt_every=0, log_every=1, grad_compression="powersgd",
                    powersgd_rank=PSGD_RANK, powersgd_min_size=PSGD_MIN_SIZE)
    dc_ = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    cpu_params = model.init(seed=0, device="cpu", dtype=torch.float32)
    card_params = copy.deepcopy(cpu_params).to(DEV)
    before = {n: p.detach().clone() for n, p in cpu_params.named_parameters()}
    met = {}
    for key, dev, params in (("cpu", "cpu", cpu_params), ("cuda", DEV, card_params)):
        state = init_train_state(params, run, mesh)
        _, m = make_train_step(model, run, mesh)(state, make_batch(dc_, cfg, 0, dev))
        met[key] = {k: float(v) for k, v in m.items()}
    worst = 1.0
    for (n, p), (_, q) in zip(cpu_params.named_parameters(), card_params.named_parameters()):
        if p.numel() >= 1000:
            a = (p.detach() - before[n]).double().flatten()
            b = (q.detach().cpu() - before[n]).double().flatten()
            worst = min(worst, float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)))
    gap = abs(met["cpu"]["loss"] - met["cuda"]["loss"])
    print(f"  one PowerSGD step (rank {PSGD_RANK}, matrices of >= {PSGD_MIN_SIZE} elements) on "
          f"the CPU and on the card: loss {met['cpu']['loss']:.6f} / {met['cuda']['loss']:.6f} "
          f"(gap {gap:.2e}), least update cosine {worst:.6f}; compressed / exact bytes "
          f"{met['cuda']['compressed_bytes']:.0f} / {met['cuda']['exact_bytes']:.0f} (CPU "
          f"{met['cpu']['compressed_bytes']:.0f} / {met['cpu']['exact_bytes']:.0f}), n_dev "
          f"{met['cuda']['n_dev']:.0f}")
    if gap > TRAIN_LOSS_ATOL or worst < TRAIN_STEP_COS or not (
            met["cuda"]["compressed_bytes"] > 0
            and met["cuda"]["compressed_bytes"] == met["cpu"]["compressed_bytes"]):
        fail(f"path 28: the card's PowerSGD step leaves the CPU port's: {met}, cosine {worst}")
    dist.destroy_process_group()
    return {"cpu": met["cpu"], "cuda": met["cuda"], "loss_gap": gap, "least_update_cos": worst}


# the training launcher's runs, each as a user runs it, without ``--device``
# (so on the card): paths 25 and 26's archs, and path 28's PowerSGD on a
# 1 x 1 x 1 mesh (at the launcher's default minimum of 65,536 elements no
# smoke matrix is compressed, hence --powersgd-min-size)
TRAIN_LAUNCHER_RUNS = {
    "train_rwkv": (["--arch", "rwkv6-3b", "--smoke", "--steps", "4"], 4),
    "train_hymba": (["--arch", "hymba-1.5b", "--smoke", "--steps", "4"], 4),
    "train_powersgd": (["--arch", TRAIN_ARCH, "--smoke", "--steps", "2", "--mesh", "1x1x1",
                        "--powersgd", "--powersgd-min-size", str(PSGD_MIN_SIZE)], 2),
}


def train_launchers() -> dict:
    """``python -m repro_torch.launch.train`` for every run of
    :data:`TRAIN_LAUNCHER_RUNS`, started together (:func:`run_together`),
    each checkpointing into a fresh directory under ``build/``: each must
    exit 0 and end with ``done at step N``, and the PowerSGD run log a
    ``compressed_bytes`` above 0."""
    import tempfile

    build = HERE / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt:
        runs = run_together({
            name: ["-m", "repro_torch.launch.train", *argv, "--ckpt-dir", f"{ckpt}/{name}"]
            for name, (argv, _) in TRAIN_LAUNCHER_RUNS.items()})
    out = {}
    for name, run in runs.items():
        argv, steps = TRAIN_LAUNCHER_RUNS[name]
        lines = run["stdout"]
        print(f"  -m repro_torch.launch.train {' '.join(argv)}: exit {run['returncode']}, ended "
              f"by {run['seconds']:.1f} s; " + " | ".join(lines))
        logged = [float(x) for x in re.findall(r"compressed_bytes=(\S+)", "\n".join(lines))]
        if run["returncode"] != 0 or not lines or lines[-1] != f"done at step {steps}" or (
                name == "train_powersgd" and not (logged and logged[0] > 0)):
            fail(f"the training launcher ({name}) exited {run['returncode']}: {lines[-20:]} "
                 f"{run['stderr'][-2000:]}")
        out[name] = {"seconds": run["seconds"], "stdout": lines}
        if name == "train_powersgd":
            out[name]["compressed_bytes"] = logged
    return out


def adaptive_rank(flush) -> dict:
    """Adaptive rank (``core.adaptive``) at ``benchmarks/bench_adaptive.py``'s
    shape: 8 heads of [512, 128] KV-like residuals (seeded, heavy-tailed,
    token-correlated, on a steep per-head energy profile, minus their kivi2
    quantization), ranks 2, 4 and 8 on the card against the CPU port: ranks
    equal, errors within ``ADAPTIVE_ERR_ATOL``; each call timed."""
    from repro_torch.core import quant
    from repro_torch.core.adaptive import adaptive_error_vs_uniform
    from repro_torch.core.policy import named_policy

    H, n, d = 8, 512, 128
    g = torch.Generator().manual_seed(0)
    u, v = torch.randn(H, n, 16, generator=g), torch.randn(H, 16, d, generator=g)
    chan = 1.0 + 4.0 * (torch.rand(H, 1, d, generator=g) < 0.03).float()
    x = (torch.randn(H, n, d, generator=g) + 1.2 * u @ v / 4.0) * chan
    x = x * (1 + 8.0 * (torch.rand(H, n, d, generator=g) < 0.005).float())
    x = x * torch.logspace(0, 1.2, H)[:, None, None]
    pol = named_policy("kivi2")
    resid = x - quant.dequantize(quant.quantize(x, pol.bits, *pol.scheme_for("k")))
    card = resid.to(DEV)
    out = {}
    for r in (2, 4, 8):
        want = adaptive_error_vs_uniform(resid, r)
        got = adaptive_error_vs_uniform(card, r)
        _, ms = on_card_ms(lambda: adaptive_error_vs_uniform(card, r))
        gaps = {k: abs(got[k] - want[k]) for k in ("uniform", "adaptive")}
        gain = (got["uniform"] - got["adaptive"]) / got["uniform"] * 100
        print(f"  r={r}: uniform {got['uniform']:.4f} adaptive {got['adaptive']:.4f} (gain "
              f"{gain:.1f}%), ranks {got['ranks']}; against the CPU port: ranks "
              f"{'equal' if got['ranks'] == want['ranks'] else want['ranks']}, error gaps "
              f"{gaps['uniform']:.1e} / {gaps['adaptive']:.1e}; {ms:.1f} ms a call (host clock)")
        if got["ranks"] != want["ranks"] or max(gaps.values()) > ADAPTIVE_ERR_ATOL:
            fail(f"adaptive rank r={r} on the card: {got} against the CPU port's {want}")
        out[f"r{r}"] = dict(got, ms=ms, gain_pct=gain)
    out["error_table"] = error_table(g)
    return out


def kv_like(g: torch.Generator, shape: tuple, outlier_p: float = 0.005,
            outlier_scale: float = 8.0, corr_rank: int = 16) -> torch.Tensor:
    """``benchmarks/common.kv_like``'s recipe on a torch generator (CPU, f32):
    a normal base plus a shared rank-``corr_rank`` token structure, 3% of
    channels scaled 5x, a fraction ``outlier_p`` of entries scaled by ``1 +
    outlier_scale``."""
    *lead, n, d = shape
    lead = tuple(lead)
    base = torch.randn(shape, generator=g)
    u = torch.randn(lead + (n, corr_rank), generator=g)
    v = torch.randn(lead + (corr_rank, d), generator=g)
    chan = 1.0 + 4.0 * (torch.rand(lead + (1, d), generator=g) < 0.03).float()
    x = (base + 1.2 * u @ v / corr_rank ** 0.5) * chan
    return x * (1 + outlier_scale * (torch.rand(shape, generator=g) < outlier_p).float())


def on_card_ms(fn):
    """``fn()`` and its host-clock milliseconds, the device synchronized
    before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def error_table(g: torch.Generator) -> dict:
    """The paper's error table at ``benchmarks/bench_error.py``'s shape, 4
    heads of [1024, 128] KV-like values drawn from ``g``, on the card against
    the CPU port: ``approx_error`` of the ten policies on K and V (each card
    call timed, each compressed size equal), ``bench_ablation.py``'s Fig. 4a
    variants on its input, kivi2's ``quant_error``, and on kivi2's K
    residual ``lowrank_approx`` and ``svd_topr`` at rank 4 (their relative
    errors) and the top-8 singular values over the first of head 0 (Fig.
    2b); gear_kcvt4's K at head dims 80 and 96 and ``lowrank_approx`` at
    rank 3 (shapes no shipped config has).  Every gap within
    ``ERROR_TABLE_ATOL``."""
    from repro_torch.core import gear, lowrank, quant
    from repro_torch.core.policy import named_policy

    shape = (1, 4, 1024, 128)
    x = kv_like(g, shape)
    x4a = (kv_like(g, shape, outlier_p=0.003, outlier_scale=5.0, corr_rank=8)
           + 2.0 * kv_like(g, shape, outlier_p=0.0, corr_rank=4))
    cpu = {"x": x, "x4a": x4a}
    for d in ERROR_HEAD_DIMS:
        cpu[f"x{d}"] = kv_like(g, shape[:-1] + (d,))
    card = {name: t.to(DEV) for name, t in cpu.items()}
    cases = {f"{name}/{kind}": ("x", named_policy(name), kind)
             for name in ERROR_METHODS for kind in ("k", "v")}
    cases.update({f"gear_kcvt4/k d={d}": (f"x{d}", named_policy("gear_kcvt4"), "k")
                  for d in ERROR_HEAD_DIMS})
    base = named_policy("gear_kivi2")
    for sp in (0.0, 0.01, 0.02, 0.05):
        pol = dc.replace(base, sparsity=max(sp, 1e-9), method="gear" if sp > 0 else "gear_l")
        cases[f"fig4a s={sp}"] = ("x4a", pol, "k")
    for r in (0, 2, 4, 8):
        pol = dc.replace(base, rank=max(r, 1), method="gear" if r > 0 else "outlier_quant")
        cases[f"fig4a r={r}"] = ("x4a", pol, "k")
    gear.approx_error(card["x"], base, "k")          # the first call's one-time costs
    rows, sizes_equal = {}, True
    for label, (src, pol, kind) in cases.items():
        want = float(gear.approx_error(cpu[src], pol, kind))
        got, ms = on_card_ms(lambda: gear.approx_error(card[src], pol, kind))
        got = float(got)
        row = {"err": got, "gap": abs(got - want), "ms": ms}
        if not label.startswith("fig4a"):
            row["bytes"] = gear.compress_matrix(card[src], pol, kind).size_bytes()
            row["bytes_cpu"] = gear.compress_matrix(cpu[src], pol, kind).size_bytes()
            sizes_equal &= row["bytes"] == row["bytes_cpu"]
        rows[label] = row
        if not np.isfinite(got) or row["gap"] > ERROR_TABLE_ATOL:
            fail(f"approx_error {label} on the card: {got} against the CPU port's {want}")
    for name in ERROR_METHODS:
        k, v = rows[f"{name}/k"], rows[f"{name}/v"]
        print(f"  {name:14s} K {k['err']:.4f} V {v['err']:.4f} (gaps {k['gap']:.1e} / "
              f"{v['gap']:.1e}; {k['bytes']} / {v['bytes']} B, equal to the CPU port's: "
              f"{k['bytes'] == k['bytes_cpu'] and v['bytes'] == v['bytes_cpu']}); "
              f"{k['ms']:.1f} / {v['ms']:.1f} ms a call (host clock)")
    print("  fig4a " + "; ".join(f"{lb[6:]} {r['err']:.4f} (gap {r['gap']:.1e}, {r['ms']:.1f} ms)"
                                 for lb, r in rows.items() if lb.startswith("fig4a")))
    print("  head dims no config has: " + "; ".join(
        f"{lb} {r['err']:.4f} (gap {r['gap']:.1e}, {r['bytes']} B, {r['ms']:.1f} ms)"
        for lb, r in rows.items() if " d=" in lb))
    if not sizes_equal:
        fail("size_bytes of a compressed matrix on the card differs from the CPU port's")
    e = {name: rows[f"{name}/k"]["err"] for name in ERROR_METHODS}
    order = {"gear_kivi2 < gear_l_kivi2 < kivi2 < per_token_q2":
             e["gear_kivi2"] < e["gear_l_kivi2"] < e["kivi2"] < e["per_token_q2"],
             "outlier_kivi2 < kivi2": e["outlier_kivi2"] < e["kivi2"]}
    print(f"  bench_error.py's orderings on K (reported, not gated): {order}")

    kivi2 = named_policy("kivi2")
    extra = {}
    for kind in ("k", "v"):
        scheme = kivi2.scheme_for(kind)
        want = float(quant.quant_error(cpu["x"], kivi2.bits, *scheme))
        got = float(quant.quant_error(card["x"], kivi2.bits, *scheme))
        extra[f"quant_error/{kind}"] = (got, abs(got - want))

    def residual_errors(xk: torch.Tensor) -> dict:
        resid = xk - quant.dequantize(quant.quantize(xk, kivi2.bits, *kivi2.scheme_for("k")))
        norm = torch.linalg.vector_norm(resid)
        sv = torch.linalg.svdvals(resid[0, 0])
        return {"lowrank_approx r=4": float(torch.linalg.vector_norm(
                    resid - lowrank.lowrank_approx(resid, 4)) / norm),
                "lowrank_approx r=3": float(torch.linalg.vector_norm(
                    resid - lowrank.lowrank_approx(resid, 3)) / norm),
                "svd_topr r=4": float(torch.linalg.vector_norm(
                    resid - lowrank.svd_topr(resid, 4)) / norm),
                "spectrum": (sv[:8] / sv[0]).cpu()}
    want, got = residual_errors(cpu["x"]), residual_errors(card["x"])
    for key in ("lowrank_approx r=4", "lowrank_approx r=3", "svd_topr r=4"):
        extra[key] = (got[key], abs(got[key] - want[key]))
    spectrum_gap = float((got["spectrum"] - want["spectrum"]).abs().max())
    extra["spectrum top8"] = (got["spectrum"].tolist(), spectrum_gap)
    print("  " + "; ".join(f"{key} {val if isinstance(val, list) else round(val, 4)} "
                           f"(gap {gap:.1e})" for key, (val, gap) in extra.items()
                           if key != "spectrum top8"))
    print(f"  kivi2 K residual, head 0, sigma_i / sigma_0 for i < 8: "
          f"{[round(v, 3) for v in extra['spectrum top8'][0]]} (gap {spectrum_gap:.1e})")
    worst = max([r["gap"] for r in rows.values()] + [gap for _, gap in extra.values()])
    print(f"  error table: largest card-against-CPU gap {worst:.1e} (bound {ERROR_TABLE_ATOL})")
    if not worst <= ERROR_TABLE_ATOL:                # NaN fails too
        fail(f"error table on the card: {extra} (bound {ERROR_TABLE_ATOL})")
    return {"rows": rows, "extra": {k: {"value": v, "gap": gap} for k, (v, gap) in extra.items()},
            "orderings": order, "largest_gap": worst, "sizes_equal": sizes_equal}


def main() -> int:
    global PARENT_SCAN, PARENT_SCAN_BWD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth of serving path 1, monolithic + dense (of 32); "
                         "paths 2-4 always run every layer")
    ap.add_argument("--parent-scan", type=pathlib.Path, default=None,
                    help="a parent tree's csrc/linear_scan.cu: build it too and time it in "
                         "turns (parent, this tree, this tree, parent) beside every "
                         "linear_scan_chunked case and live call, and its backward (where it "
                         "has one) beside every linear_scan_chunked_bwd case and live call")
    ap.add_argument("--parent-kernels", type=pathlib.Path, default=None,
                    help="a parent tree's csrc directory: build its flash_prefill_block.cu, "
                         "gear_compress.cu and quant_pack.cu too and time them in turns "
                         "(parent, this tree, this tree, parent) beside every case of phases "
                         "5, 6 and 9 and at phase 11's live calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("[1] environment")
    card = smi()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"  {card}")

    phase("[2] build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    parent = None if args.parent_scan is None else start_parent_build(args.parent_scan)
    parents = ({} if args.parent_kernels is None else
               {name: start_parent_build(args.parent_kernels / f"{name}.cu")
                for name in PARENT_SOURCES})
    built = _build.build_all()
    for name, (sec, log) in sorted(built.items()):
        print(f"  {name}: built in {sec:.1f} s; {ptxas_summary(log)}")
    if parent is not None:
        PARENT_SCAN, PARENT_SCAN_BWD = parent_scan(*parent)
    for name, (proc, lib) in parents.items():
        PARENT_KERNELS[name] = parent_kernel(name, proc, lib)
    print(f"  build wall {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)  # > 50 MB L2
    reports = {
        "gear_decode": {"name": "gear_decode", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/gear_decode.cu",
                        "replaces": "src/repro/kernels/gear_decode.py:183"},
        "flash_prefill": {"name": "flash_prefill", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
                          "replaces": "src/repro/kernels/flash_prefill.py:101"},
        "gear_compress": {"name": "gear_compress", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/gear_compress.cu",
                          "replaces": "src/repro/kernels/gear_compress.py:174"},
        "flash_prefill_block": {"name": "flash_prefill_block", "route": "cuda",
                                "source": "src/repro_torch/kernels/csrc/flash_prefill_block.cu",
                                "replaces": "src/repro/kernels/flash_prefill.py:160"},
        "gear_decode_paged": {"name": "gear_decode_paged", "route": "cuda",
                              "source": "src/repro_torch/kernels/csrc/gear_decode_paged.cu",
                              "replaces": "src/repro/kernels/gear_decode.py:316"},
        "linear_scan_chunked": {"name": "linear_scan_chunked", "route": "cuda",
                                "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
                                "replaces": "src/repro/kernels/linear_scan_kernel.py:94"},
        "quant_pack": {"name": "quant_pack", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/quant_pack.cu",
                       "replaces": "src/repro/kernels/quant_pack.py:53"},
        # the reference differentiates its XLA chunked_scan (no Pallas backward)
        "linear_scan_chunked_bwd": {"name": "linear_scan_chunked_bwd", "route": "cuda",
                                    "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
                                    "replaces": "src/repro/models/linear_scan.py:30",
                                    "library_ms": None, "launches_by_path": {}},
    }
    phase("[3] gear_decode vs plain")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        decode_case(pol, flush, reports["gear_decode"])
        decode_case(pol, flush, reports["gear_decode"], H=5, Dh=64, G=5)     # hymba
        # gemma-2b's live shape: 4 slots x 1 kv head, G 8, head_dim 256
        decode_case(pol, flush, reports["gear_decode"], H=1, Dh=256, G=8,
                    timed="_gemma" if pol == "gear_kcvt4" else "_gemma_kivi2")
    decode_case("gear_kcvt4", flush, reports["gear_decode"], H=8, Dh=256, G=2)  # gemma3's G
    # starcoder2-3b: 24 query heads over 2 kv heads (G = 12, the 16-row build)
    decode_case("gear_kcvt4", flush, reports["gear_decode"], H=2, Dh=128, G=12,
                timed="_starcoder2")
    # qwen3-moe: 64 query heads over 4 kv heads (G = 16, every row of the
    # 16-row build), both policies; llama4-scout: 40 over 8 (G = 5) at Dh 128
    decode_case("gear_kcvt4", flush, reports["gear_decode"], H=4, Dh=128, G=16, timed="_qwen3")
    decode_case("gear_kivi2", flush, reports["gear_decode"], H=4, Dh=128, G=16,
                timed="_qwen3_kivi2")
    decode_case("gear_kcvt4", flush, reports["gear_decode"], H=8, Dh=128, G=5, timed="_llama4")
    history_case(flush, reports["gear_decode"])
    for pol, suffix in (("gear_kcvt4", "_gemma"), ("gear_kivi2", "_gemma_kivi2")):
        history_case(flush, reports["gear_decode"], H=1, Dh=256, G=8, policy_name=pol,
                     suffix=suffix)
    phase("[4] flash_prefill vs plain")
    for i, case in enumerate(FLASH_CASES):
        flash_case(case, flush, reports["flash_prefill"], TIMED_FLASH_CASES.get(i))
    phase("[5] gear_compress vs plain")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        compress_case(pol, flush, reports["gear_compress"])
    phase("[6] flash_prefill_block vs plain")
    for T, rep in ((64, 1), (64, 4), (37, 1)):
        block_case(T, rep, flush, reports["flash_prefill_block"])
    phase("[7] gear_decode_paged vs plain and vs gear_decode")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        paged_case(pol, reports["gear_decode_paged"])
        paged_case(pol, reports["gear_decode_paged"], H=1, Dh=256, G=8)   # gemma-2b

    phase("[8] linear_scan_chunked vs plain, forward and backward")
    for case in SCAN_CASES:
        scan_case(case, flush, reports["linear_scan_chunked"])
    bwd = reports["linear_scan_chunked_bwd"]
    for case in SCAN_CASES:
        scan_bwd_case(case, flush, bwd, list_kernels=True)
    for key, case in SCAN_BWD_TRAIN_CASES.items():
        timed = scan_bwd_case(case, flush, bwd, dstate_zero=True, list_kernels=True)
        names = ("ms", "plain_ms", "bound_ms", "bound_by")
        bwd.update(dict(zip(names, timed)) if key == "rwkv" else
                   {f"{n}_{key}": t for n, t in zip(names, timed)})
    bwd["blocks_per_sm"] = scan_bwd_occupancy()
    phase("[9] quant_pack through kernels.quantize_chunk vs plain")
    quant_pack_phase(flush, reports["quant_pack"])

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    def build(cfg, full_layers: int):
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"  {cfg.name} width (d_model {cfg.d_model}, {cfg.num_heads} heads / "
              f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}), depth {cfg.num_layers} of {full_layers}: "
              f"{n_params / 1e9:.2f} B params, init {time.perf_counter() - t0:.1f} s")
        return model, params, cfg

    full = get_config("llama2-7b")
    built_models, summaries = {}, {}
    for num, key, layers, fn, title in (
            (10, "monolithic_dense", args.layers, serving, "monolithic prefill, dense layout"),
            (11, "streaming_paged", full.num_layers, serving_paged,
             "streaming prefill, paged pool"),
            (12, "prefix_paged", full.num_layers, serving_prefix,
             "streaming prefill, paged pool, prefix trie")):
        phase(f"[{num}] serving llama2-7b, gear_kcvt4, {title}, depth {layers}"
              + ("" if layers == full.num_layers else
                 f" (cut from {full.num_layers} by --layers)"))
        if layers not in built_models:
            built_models[layers] = build(dc.replace(full, num_layers=layers), full.num_layers)
        summaries[key] = fn(*built_models[layers], layers, flush, reports)
        if key == "monolithic_dense":
            phase(f"[10.1] serving on a 1 x 1 mesh, path 29: path 1's llama2-7b (depth "
                  f"{layers}), Engine(mesh=make_test_mesh(1, 1)), one NCCL process, path 1's "
                  f"first {MESH_REQUESTS} requests (its launcher run is in phase 21)")
            summaries["mesh_dense"] = serving_mesh(*built_models[layers], layers, flush,
                                                   reports, summaries[key])
            phase(f"[10.2] sampled serving: the jax.random stream on the card against the CPU's "
                  f"on path 1's live logits, sample at temperature {SAMPLE_TEMPERATURE}, then path "
                  f"29's {MESH_REQUESTS} requests x {SAMPLED_TOKENS} tokens sampled on path 1's "
                  f"llama2-7b (depth {layers})")
            summaries["sampled_dense"] = serving_sampled(*built_models[layers], layers, flush,
                                                         summaries["mesh_dense"])
    built_models.clear()                  # free llama2-7b before hymba's peak is read
    torch.cuda.empty_cache()

    hymba = get_config("hymba-1.5b")
    phase(f"[13] serving hymba-1.5b, gear_kcvt4, monolithic prefill, dense layout, depth "
          f"{hymba.num_layers}")
    built_hymba = build(hymba, hymba.num_layers)
    summaries["hybrid_dense"] = serving_hybrid(*built_hymba, hymba.num_layers, flush, reports)
    phase(f"[14] serving hymba-1.5b, gear_kcvt4, streaming prefill (unbucketed), dense layout, "
          f"depth {hymba.num_layers}, {HYBRID_STREAM_TOKENS} new tokens per request")
    summaries["hybrid_streaming"] = serving_hybrid_streaming(*built_hymba, hymba.num_layers,
                                                             flush, reports)
    del built_hymba
    gc.collect()                          # free hymba before rwkv6-3b's peak is read
    torch.cuda.empty_cache()

    rwkv6 = get_config("rwkv6-3b")
    phase(f"[15] serving rwkv6-3b, monolithic prefill, dense layout (no KV cache), depth "
          f"{rwkv6.num_layers}; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before")
    summaries["rwkv_dense"] = serving_rwkv(*build(rwkv6, rwkv6.num_layers), rwkv6.num_layers,
                                           flush, reports)
    gc.collect()                          # free rwkv6-3b before llama2-7b is built again
    torch.cuda.empty_cache()

    wave_layers = min(args.layers, WAVE_LAYERS)
    phase(f"[16] serving llama2-7b, gear_kcvt4, wave mode (Scheduler.run: monolithic prefill of "
          f"each wave at batch {B_SERVE}, dense layout), depth {wave_layers} (cut from "
          f"{full.num_layers} to make room for path 29, which took "
          f"{PHASE_S['[10.2]'] - PHASE_S['[10.1]']:.1f} s)")
    built_models[wave_layers] = build(dc.replace(full, num_layers=wave_layers), full.num_layers)
    summaries["wave_dense"] = serving_wave(*built_models[wave_layers], wave_layers, flush,
                                           reports)
    phase(f"[17] serving llama2-7b, gear_kcvt4, streaming prefill, paged pool, prefix trie, "
          f"telemetry and injected faults, depth {full.num_layers}")
    if full.num_layers not in built_models:
        built_models.clear()
        gc.collect()
        torch.cuda.empty_cache()
        built_models[full.num_layers] = build(full, full.num_layers)
    summaries["resilience_paged"] = serving_resilience(*built_models[full.num_layers],
                                                       full.num_layers, flush, reports)
    llama = built_models[full.num_layers]
    phase(f"[18] serving llama2-7b, fp16 (the paper's baseline), monolithic prefill, dense "
          f"layout, depth {full.num_layers}")
    summaries["fp16_dense"] = serving_fp16(*llama, full.num_layers, flush, reports,
                                           summaries["monolithic_dense"])
    phase(f"[19] serving llama2-7b, per_token_q4 (the portable attend path), monolithic "
          f"prefill, paged pool, depth {full.num_layers}, {PER_TOKEN_TOKENS} new tokens per "
          f"request")
    summaries["per_token_paged"] = serving_per_token_paged(*llama, full.num_layers, flush,
                                                           reports)
    phase(f"[20] serving llama2-7b, gear_kcvt4, path 5's engine with telemetry, then with the "
          f"fidelity probes, depth {full.num_layers}")
    summaries["telemetry_paged"] = serving_telemetry(*llama, full.num_layers, flush, reports,
                                                     summaries["prefix_paged"])
    del llama
    built_models.clear()                  # the launcher builds its own model
    gc.collect()
    torch.cuda.empty_cache()
    phase("[21] the launcher, python -m repro_torch.launch.serve, llama2-7b at full width: "
          "wave mode, continuous + paged mode, and path 29's wave mode on a 1 x 1 mesh, "
          "started together")
    summaries["launcher"] = launcher_runs()
    summaries["mesh_dense"]["launcher"] = summaries["launcher"]["mesh_wave"]

    gemma = get_config("gemma-2b")
    phase(f"[22] serving gemma-2b, gear_kcvt4, monolithic prefill, dense layout, depth "
          f"{gemma.num_layers}")
    built_gemma = build(gemma, gemma.num_layers)
    summaries["gemma_dense"] = serving_family(*built_gemma, gemma.num_layers, flush, reports,
                                              "gemma_dense", "_gemma", NEW_TOKENS, False)
    phase(f"[23] serving gemma-2b, gear_kivi2, streaming prefill, paged pool, depth "
          f"{gemma.num_layers}, {FAMILY_TOKENS} new tokens per request")
    summaries["gemma_streaming_paged"] = serving_gemma_paged(*built_gemma, gemma.num_layers,
                                                             flush, reports)
    del built_gemma
    gc.collect()
    torch.cuda.empty_cache()
    for num, arch, key, suffix in ((24, "starcoder2-3b", "starcoder2_dense", "_starcoder2"),
                                   (25, "minicpm-2b", "minicpm_dense", "_minicpm")):
        fam = get_config(arch)
        phase(f"[{num}] serving {arch}, gear_kcvt4, monolithic prefill, dense layout, depth "
              f"{fam.num_layers}, {FAMILY_TOKENS} new tokens per request")
        summaries[key] = serving_family(*build(fam, fam.num_layers), fam.num_layers, flush,
                                        reports, key, suffix, FAMILY_TOKENS, False)
        gc.collect()
        torch.cuda.empty_cache()

    gemma3 = get_config("gemma3-12b")
    phase(f"[26] serving gemma3-12b, gear_kcvt4, monolithic prefill, dense layout, depth "
          f"{gemma3.num_layers}, {GEMMA3_TOKENS} new tokens per request")
    built_gemma3 = build(gemma3, gemma3.num_layers)
    summaries["gemma3_dense"] = serving_gemma3(*built_gemma3, gemma3.num_layers, flush, reports)
    phase(f"[27] serving gemma3-12b, gear_kcvt4, streaming prefill, paged pool, depth "
          f"{gemma3.num_layers}, {GEMMA3_TOKENS} new tokens per request")
    summaries["gemma3_streaming_paged"] = serving_gemma3_paged(*built_gemma3, gemma3.num_layers,
                                                               flush, reports)
    del built_gemma3
    gc.collect()
    torch.cuda.empty_cache()
    vlm = get_config("paligemma-3b")
    phase(f"[28] serving paligemma-3b, gear_kcvt4, monolithic prefill, dense layout, depth "
          f"{vlm.num_layers}: a wave with image embeddings, then continuous batching")
    summaries["paligemma_dense"] = serving_vlm(*build(vlm, vlm.num_layers), vlm.num_layers,
                                               flush, reports)
    gc.collect()
    torch.cuda.empty_cache()

    music = get_config("musicgen-medium")
    phase(f"[29] serving musicgen-medium, gear_kcvt4, one wave (Engine.generate: monolithic "
          f"prefill, dense layout), depth {music.num_layers}, {MUSIC_TOKENS} new frames")
    summaries["musicgen_wave"] = serving_audio(*build(music, music.num_layers), music.num_layers,
                                               flush, reports)
    gc.collect()
    torch.cuda.empty_cache()
    for num, arch, key, suffix in ((30, "qwen3-moe-235b-a22b", "qwen3_dense", "_qwen3"),
                                   (31, "llama4-scout-17b-a16e", "llama4_dense", "_llama4")):
        full_moe = get_config(arch)
        phase(f"[{num}] serving {arch}, gear_kcvt4, monolithic prefill, dense layout, depth "
              f"{MOE_LAYERS} (cut from {full_moe.num_layers}: memory, the weights of ~15 layers "
              f"fill the card), {MOE_TOKENS} new tokens per request")
        built_moe = build(dc.replace(full_moe, num_layers=MOE_LAYERS), full_moe.num_layers)
        summaries[key] = serving_moe(*built_moe, MOE_LAYERS, flush, reports, key, suffix,
                                     profiled=key == "qwen3_dense")
        if arch == "llama4-scout-17b-a16e":
            phase(f"[32] serving {arch}, gear_kcvt4, streaming prefill, paged pool, depth "
                  f"{MOE_LAYERS} (cut from {full_moe.num_layers}), {MOE_TOKENS} new tokens "
                  f"per request")
            summaries["llama4_streaming_paged"] = serving_moe_paged(*built_moe, MOE_LAYERS,
                                                                    flush, reports)
        del built_moe
        gc.collect()
        torch.cuda.empty_cache()

    phase(f"[33] training, path 23: {TRAIN_ARCH} at full width and depth, {TRAIN_STEPS} steps "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, remat dots")
    summaries["train_full"] = training(flush, reports)
    phase(f"[34] training, path 24: {len(CROSS_ARCHS)} smoke configs, one step on the CPU port "
          f"and on the card, then {TRAIN_ARCH} 6 steps straight against 3 + restore + 3")
    summaries["train_cross"] = training_cross()
    phase("[35] adaptive rank at bench_adaptive.py's shape (8 heads of [512, 128]), then the "
          "paper's error table at bench_error.py's shape (4 heads of [1024, 128]), card against "
          "the CPU port")
    summaries["adaptive_rank"] = adaptive_rank(flush)
    for num, arch, key in ((36, "rwkv6-3b", "train_rwkv"), (37, "hymba-1.5b", "train_hymba")):
        phase(f"[{num}] training, path {num - 11}: {arch} at full width and depth, "
              f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
              f"microbatches, remat dots, the scan's backward kernel")
        summaries[key] = training(flush, reports, arch, key)

    phase(f"[38] training, path 27: {TRAIN_ARCH} at full width and depth, path 23's recipe "
          f"through train_loop on a 1 x 1 mesh (one NCCL process), ZeRO-1 on, 3 steps")
    summaries["train_mesh"] = training_mesh(summaries["train_full"])
    phase(f"[39] training, path 28: PowerSGD on a 1 x 1 x 1 (pod, data, model) mesh, "
          f"{TRAIN_ARCH} smoke, one step on the card against the CPU port")
    summaries["train_powersgd"] = training_powersgd()
    phase("[40] the training launcher, python -m repro_torch.launch.train: paths 25 and 26's "
          "archs and path 28's PowerSGD mesh, smoke configs, started together")
    for key, run in train_launchers().items():
        summaries[key]["launcher"] = run

    phase("[41] summary")
    keys = ("name", "route", "source", "replaces", "launches", "err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for rep in reports.values():
        if "launches_by_path" in rep:
            rep["launches"] = sum(rep["launches_by_path"].values())
    kernels = []
    for rep in reports.values():
        row = {("max_abs_err" if k == "err" else k): rep[k] for k in keys}
        row.update({k: v for k, v in rep.items() if k not in keys})
        kernels.append(row)
    marks = list(PHASE_S.items())
    spans = {name: round(nxt - t, 1) for (name, t), (_, nxt) in zip(marks, marks[1:])}
    print(f"  seconds per phase {spans}; {time.perf_counter() - _T0:.1f} s since the start")
    summaries["phase_seconds"] = spans
    print(json.dumps({"serving": summaries}))
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
