"""Training launcher (port of ``repro.launch.train``: the same flags).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --steps 50 \
      --batch 8 --seq 256 [--smoke] [--microbatches 2] [--device cpu]

Trains on one device: CUDA unless ``--device`` names another (nothing falls
back to the CPU when CUDA is absent).  Weights start from
``Model.init(seed=0)`` in f32; batches come from
:mod:`repro_torch.data.synthetic` (the reference's token stream, bit for
bit).  Remat per layer with the ``dots`` policy, AdamW on the config's
schedule, checkpoints under ``--ckpt-dir`` every ``--ckpt-every`` steps, and
a resume from the latest one there.  ``--mesh`` and ``--production-mesh``
(sharding, ROADMAP queue 1, item 10) exit with a message; ``--powersgd``
and ``--no-zero1`` are accepted and change nothing on one device, as on the
reference's one-device mesh.  Every family trains on either device; an
RWKV6 or hybrid model's scan runs ``linear_scan_chunked`` and its backward
kernel on the card.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import DataConfig
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
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)
    if args.mesh or args.production_mesh:
        raise SystemExit("--mesh / --production-mesh: sharding over a device mesh is not "
                         "ported (ROADMAP queue 1, item 10)")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    run = RunConfig(
        total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
        microbatches=args.microbatches, remat=True, remat_policy="dots",
        zero1=not args.no_zero1,
        grad_compression="powersgd" if args.powersgd else "none",
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=10)
    dc = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    state = train_loop(model, run, dc, device=args.device)
    print(f"done at step {state.step}")


if __name__ == "__main__":
    main()
