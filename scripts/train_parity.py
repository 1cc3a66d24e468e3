#!/usr/bin/env python
"""Train steps of the port against the JAX reference, on the CPU, at a width
the tests do not reach.

Both packages start from the reference's f32 master weights (the port's
through ``params_from_reference(..., dtype=torch.float32)``) and take the
same batches (``data.synthetic`` draws the reference's tokens bit for bit);
the reference runs the body of its one-device train step, jitted
(``_accum_grads``, ``lr_at``, ``adamw_update``: its sharded step does not
compile under jax 0.9, ROADMAP §3 n).  Prints each step's loss and grad norm
from both.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_parity.py \
        [--arch minicpm-2b] [--layers 4] [--d-model 512] [--steps 8] [--warmup 1]

Heads are d_model / head_dim (as many KV heads), d_ff 2.5 x d_model; the
vocabulary is the config's.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.data import synthetic as ref_data
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro.train import loop as ref_loop
from repro.train import state as ref_state
from repro_torch.configs import get_config
from repro_torch.data import synthetic
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import build_model
from repro_torch.train.loop import make_train_step
from repro_torch.train.state import RunConfig, init_train_state


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args()

    base = ref_get_config(args.arch)
    heads = args.d_model // base.head_dim
    over = dict(num_layers=args.layers, d_model=args.d_model, num_heads=heads,
                num_kv_heads=heads, d_ff=args.d_model * 5 // 2)
    rcfg = dataclasses.replace(base, **over)
    pcfg = dataclasses.replace(get_config(args.arch), **over)
    kw = dict(total_steps=args.steps, warmup_steps=args.warmup, microbatches=2, remat=True,
              remat_policy="dots")
    rrun = ref_state.RunConfig(**kw)
    m = ref_build_model(rcfg)

    def ref_step(state, batch):
        loss, metrics, grads = ref_loop._accum_grads(m, state.params, batch, rrun)
        lr = ref_schedule.lr_at(state.step, peak=rrun.optimizer.lr_peak,
                                total_steps=rrun.total_steps, warmup=rrun.warmup_steps,
                                kind=rcfg.lr_schedule)
        params, opt, om = ref_adamw.adamw_update(rrun.optimizer, grads, state.opt,
                                                 state.params, lr)
        return (ref_state.TrainState(params=params, opt=opt, step=state.step + 1, ef=state.ef),
                dict(metrics, loss=loss, lr=lr, **om))

    params = m.init(jax.random.PRNGKey(0))
    rstate = ref_state.init_train_state(params, rrun)
    rstep = jax.jit(ref_step)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg, "cpu", torch.float32)
    pstate = init_train_state(model, RunConfig(**kw))
    pstep = make_train_step(build_model(pcfg), RunConfig(**kw))
    dkw = dict(seed=0, vocab_size=rcfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    n = sum(p.numel() for p in model.parameters())
    print(f"{args.arch}: {args.layers} layers, d_model {args.d_model}, {n / 1e6:.1f} M parameters")
    for s in range(args.steps):
        rstate, rm = rstep(rstate, ref_data.make_batch(ref_data.DataConfig(**dkw), rcfg, s))
        pstate, pm = pstep(pstate, synthetic.make_batch(synthetic.DataConfig(**dkw), pcfg, s,
                                                        "cpu"))
        print(f"step {s}: loss reference {float(rm['loss']):.4f} port {float(pm['loss']):.4f}; "
              f"grad norm reference {float(rm['grad_norm']):.4f} port "
              f"{float(pm['grad_norm']):.4f}", flush=True)


if __name__ == "__main__":
    main()
