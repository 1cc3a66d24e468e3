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
``[batch, prompt]`` block (an audio model's ``[batch, prompt,
num_codebooks]``; for a VLM a ``[batch, num_prefix_tokens, d_model]`` block
of standard-normal image embeddings, in bf16, after it), continuous mode one
mixed-length prompt per request (``--prompt`` is the longest, half of it
the shortest; text models only, as the reference's launcher: an MoE model
takes it, an audio model or a VLM exits).  They cannot equal the reference
launcher's ``jax.random`` draws, so the two launchers serve different
prompts.  A VLM's capacity
holds its image prefix too.

``--device`` (default ``cuda``) names the device; nothing falls back to the
CPU when CUDA is absent.  ``--fidelity-every N`` turns on telemetry with the
fidelity probes (one FP16 shadow prefill every Nth closed chunk).

``--mesh dxm`` (``pxdxm`` adds a ``pod`` axis) serves on a data × model
mesh (:mod:`repro_torch.launch.mesh`), one process per device:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2 --device cpu ...

Every process serves the same requests and keeps its shard of the weights
and the caches (:class:`~repro_torch.serving.Engine` with ``mesh``); only
rank 0 prints.  A mesh that is not the job's world size exits with the
mesh's message; the paged layout exits on a mesh, as the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.policy import named_policy
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, EngineConfig, ObsConfig, Request, Scheduler
from repro_torch.serving.engine import PAGED_ON_MESH


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--policy", default="gear_kcvt4")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--buffer", type=int, default=0, help="override n_b")
    ap.add_argument("--mesh", default="", help="e.g. 2x2 or 2x2x2 (pod,data,model)")
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
                    help="obs: probe every Nth closed chunk (0 = off)")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics registry snapshot here (JSON; implies --obs)")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace_event JSON here (implies --obs)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu for the plain kernel versions)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        dims = [int(v) for v in args.mesh.split("x")]
        if len(dims) not in (2, 3):
            raise SystemExit(f"--mesh {args.mesh}: expected dxm or pxdxm")
        if args.layout == "paged":
            raise SystemExit(f"--layout paged: {PAGED_ON_MESH}")
        try:
            mesh = make_test_mesh(*dims[-2:], pod=dims[0] if len(dims) == 3 else 0,
                                  device=args.device)
        except RuntimeError as e:
            raise SystemExit(str(e)) from None
    try:
        _serve(args, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(args, mesh) -> None:
    # every process serves; only rank 0 of a mesh prints and writes files
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *_: None)
    if args.metrics_json or args.trace_out or args.fidelity_every:
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
    cap = args.prompt + args.gen + (cfg.num_prefix_tokens if cfg.modality == "vlm" else 0)
    eng = Engine(model, params,
                 EngineConfig(batch=args.batch, capacity=cap, policy=pol,
                              temperature=args.temperature, layout=args.layout,
                              pool_bytes=args.pool_bytes,
                              obs=(ObsConfig(fidelity_every_n=max(args.fidelity_every, 0))
                                   if args.obs else None)),
                 device=args.device, mesh=mesh)
    rng = np.random.RandomState(1)

    if args.mode == "continuous":
        if cfg.modality != "text":
            raise SystemExit("continuous mode drives text tokens")
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
        say(line)
        if eng.obs is not None:
            cov = eng.obs.tracer.coverage([r.rid for r in results])
            line = (f"obs: traces {len(cov['statuses'])}/{len(results)} rids"
                    f" complete={cov['complete']}")
            if eng.obs.fidelity is not None:
                line += f", fidelity probes {len(eng.obs.fidelity.reports)}"
            say(line)
            if args.metrics_json and lead:
                pathlib.Path(args.metrics_json).parent.mkdir(parents=True, exist_ok=True)
                eng.obs.write_metrics_json(args.metrics_json)
                say(f"obs: metrics snapshot -> {args.metrics_json}")
            if args.trace_out and lead:
                pathlib.Path(args.trace_out).parent.mkdir(parents=True, exist_ok=True)
                eng.obs.write_trace(args.trace_out)
                say(f"obs: chrome trace -> {args.trace_out}")
        return

    shape = (args.batch, args.prompt) + ((cfg.num_codebooks,) if cfg.modality == "audio" else ())
    batch = {"tokens": rng.randint(0, cfg.vocab_size, size=shape).astype(np.int32)}
    if cfg.modality == "vlm":
        img = rng.standard_normal((args.batch, cfg.num_prefix_tokens, cfg.d_model))
        batch["img_embeds"] = torch.from_numpy(img.astype(np.float32)).to(torch.bfloat16)
    toks, stats = eng.generate(batch, args.gen)
    say(f"generated {toks.shape}; prefill {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_s']:.2f}s ({stats['decode_tok_per_s']:.1f} tok/s), "
          f"cache {stats['cache_bytes']/1e6:.1f} MB")


if __name__ == "__main__":
    main()
