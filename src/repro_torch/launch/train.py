"""Training launcher (port of ``repro.launch.train``: the same flags).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --steps 50 \
      --batch 8 --seq 256 [--smoke] [--microbatches 2] [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
      --mesh 2x2 [--powersgd] [--no-zero1] [--device cpu]

Trains on CUDA unless ``--device`` names another (nothing falls back to the
CPU when CUDA is absent).  Weights start from ``Model.init(seed=0)`` in
f32; batches come from :mod:`repro_torch.data.synthetic` (the reference's
token stream, bit for bit).  Remat per layer with the ``dots`` policy,
AdamW on the config's schedule, checkpoints under ``--ckpt-dir`` every
``--ckpt-every`` steps, and a resume from the latest one there.

Without a mesh flag the job is one process on one device.  ``--mesh dxm``
(``pxdxm`` adds a ``pod`` axis) trains on a data × model mesh over the
processes ``torchrun`` started, one device each (NCCL on CUDA, gloo on the
CPU): the batch splits over the data axes, each process stores its shard
of the parameters, and the AdamW moments shard over the data axes too
unless ``--no-zero1``.  ``--production-mesh`` is the 16×16 mesh (2×16×16
with ``--multi-pod``).  A mesh that is not the job's world size exits
non-zero, naming the world size it needs.  ``--powersgd`` compresses the
gradients across the ``pod`` axis (PowerSGD, rank 8, for matrices of
``--powersgd-min-size`` elements or more); without a pod axis it changes
nothing, as on the reference's mesh.  Every family trains on
either device; an RWKV6 or hybrid model's scan runs ``linear_scan_chunked``
and its backward kernel on the card.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.model import build_model
from repro_torch.train.loop import train_loop
from repro_torch.train.state import RunConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", default="", help="e.g. 2x2 or 2x2x2 (pod,data,model)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--powersgd", action="store_true")
    ap.add_argument("--powersgd-min-size", type=int, default=RunConfig.powersgd_min_size)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)
    mesh = None
    try:
        if args.production_mesh:
            mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
        elif args.mesh:
            dims = [int(v) for v in args.mesh.split("x")]
            if len(dims) not in (2, 3):
                raise SystemExit(f"--mesh {args.mesh}: expected dxm or pxdxm")
            mesh = make_test_mesh(*dims[-2:], pod=dims[0] if len(dims) == 3 else 0,
                                  device=args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    run = RunConfig(
        total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
        microbatches=args.microbatches, remat=True, remat_policy="dots",
        zero1=not args.no_zero1,
        grad_compression="powersgd" if args.powersgd else "none",
        powersgd_min_size=args.powersgd_min_size,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=10)
    dc = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    if mesh is None:
        state = train_loop(model, run, dc, device=args.device)
        print(f"done at step {state.step}")
        return
    try:
        state = train_loop(model, run, dc, mesh=mesh)
        if dist.get_rank() == 0:
            print(f"done at step {state.step}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
