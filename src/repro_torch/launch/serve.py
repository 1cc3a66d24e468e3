"""Serving launcher: batched generation with a GEAR-compressed cache (port of
``repro.launch.serve``: the same flags and printed lines).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --smoke \
      --policy gear_kcvt4 --batch 4 --prompt 64 --gen 32 [--device cpu]

Built on the public :mod:`repro_torch.serving` API.  ``--mode wave`` drives
:meth:`Engine.generate` in lockstep; ``--mode continuous`` submits one
:class:`Request` per prompt to :meth:`Scheduler.run_continuous`.
``--layout paged`` serves from the pooled page layout (continuous mode only)
and ``--obs`` turns on telemetry (continuous mode too: traces follow the
request lifecycle).  Weights are random, from ``Model.init(seed=0)``.

The prompts come from numpy's seeded ``RandomState(1)``: wave mode draws a
``[batch, prompt]`` block, continuous mode one mixed-length prompt per
request (``--prompt`` is the longest, half of it the shortest).  They cannot
equal the reference launcher's ``jax.random.randint`` draws, so the two
launchers serve different prompts.

``--device`` (default ``cuda``) names the device; nothing falls back to the
CPU when CUDA is absent.  ``--mesh`` (sharding, ROADMAP queue 1, item 10)
and ``--fidelity-every`` (the fidelity probes, item 7) exit with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.policy import named_policy
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, EngineConfig, ObsConfig, Request, Scheduler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--policy", default="gear_kcvt4")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--buffer", type=int, default=0, help="override n_b")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mode", default="wave", choices=["wave", "continuous"])
    ap.add_argument("--layout", default="dense", choices=["dense", "paged"])
    ap.add_argument("--pool-bytes", type=int, default=0,
                    help="paged: pool device-byte budget (default: dense-"
                         "equivalent batch*n_chunks pages)")
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous: queued requests (default 2*batch)")
    ap.add_argument("--obs", action="store_true",
                    help="enable serving telemetry (metrics + traces)")
    ap.add_argument("--fidelity-every", type=int, default=0,
                    help="obs: probe every Nth closed chunk (0 = off; not ported)")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics registry snapshot here (JSON; implies --obs)")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace_event JSON here (implies --obs)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu for the plain kernel versions)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh: sharding over a device mesh is not ported "
                         "(ROADMAP queue 1, item 10)")
    if args.fidelity_every:
        raise SystemExit("--fidelity-every: the fidelity probes are not ported "
                         "(ROADMAP queue 1, item 7)")
    if args.metrics_json or args.trace_out:
        args.obs = True

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    pol = named_policy(args.policy)
    if args.buffer:
        pol = dataclasses.replace(pol, buffer_size=args.buffer, group=min(pol.group, args.buffer))
    if args.layout == "paged" and args.mode == "wave":
        args.mode = "continuous"   # paged serves through continuous batching
    if args.obs and args.mode == "wave":
        args.mode = "continuous"   # traces span the request lifecycle

    params = model.init(seed=0, device=args.device)
    cap = args.prompt + args.gen
    eng = Engine(model, params,
                 EngineConfig(batch=args.batch, capacity=cap, policy=pol,
                              temperature=args.temperature, layout=args.layout,
                              pool_bytes=args.pool_bytes,
                              obs=ObsConfig() if args.obs else None),
                 device=args.device)
    rng = np.random.RandomState(1)

    if args.mode == "continuous":
        sched = Scheduler(eng)
        n_req = args.requests or 2 * args.batch
        # mixed-length raw prompts (--prompt is the longest): the engine
        # length-buckets each one, no scheduler padding
        lo = max(1, args.prompt // 2)
        for rid in range(n_req):
            plen = lo + rid % (args.prompt - lo + 1)
            toks = rng.randint(0, cfg.vocab_size, size=plen).astype(np.int32)
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=args.gen))
        results = sched.run_continuous()
        st = sched.last_stats
        line = (f"served {len(results)} requests ({st['tokens']} tokens) in "
                f"{st['wall_s']:.2f}s; attend={st['attend_path']} layout={st['layout']}")
        if "pool" in st:
            p = st["pool"]
            line += (f"; pool {p['used_pages']}/{p['used_pages'] + p['free_pages']}"
                     f" pages used, {p['shared_pages']} shared")
        print(line)
        if eng.obs is not None:
            cov = eng.obs.tracer.coverage([r.rid for r in results])
            print(f"obs: traces {len(cov['statuses'])}/{len(results)} rids"
                  f" complete={cov['complete']}")
            if args.metrics_json:
                pathlib.Path(args.metrics_json).parent.mkdir(parents=True, exist_ok=True)
                eng.obs.write_metrics_json(args.metrics_json)
                print(f"obs: metrics snapshot -> {args.metrics_json}")
            if args.trace_out:
                pathlib.Path(args.trace_out).parent.mkdir(parents=True, exist_ok=True)
                eng.obs.write_trace(args.trace_out)
                print(f"obs: chrome trace -> {args.trace_out}")
        return

    batch = {"tokens": rng.randint(0, cfg.vocab_size, size=(args.batch, args.prompt))
             .astype(np.int32)}
    toks, stats = eng.generate(batch, args.gen)
    print(f"generated {toks.shape}; prefill {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_s']:.2f}s ({stats['decode_tok_per_s']:.1f} tok/s), "
          f"cache {stats['cache_bytes']/1e6:.1f} MB")


if __name__ == "__main__":
    main()
