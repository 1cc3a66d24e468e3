"""Production-mesh dry run: trace every (arch × shape × mesh) cell on one host
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 forced host devices and
reads its FLOPs and bytes from the jaxpr and its collectives from the
compiled HLO.  The port has neither.  Its twin plays rank 0 of a fake
process group of the production mesh's size (256 processes for the 16×16
``(data, model)`` mesh, 512 for 2×16×16 ``(pod, data, model)``;
``torch.testing._internal.distributed.fake_pg``), with every tensor on the
meta device, and runs the port's own step there once:

* ``train_4k``: the mesh train step (``make_train_step`` with a mesh;
  microbatches 8, ``dots`` remat, ZeRO-1), on this process's shard of the
  f32 parameters and the AdamW moments and the global batch;
* ``prefill_32k``: the mesh serving engine's wave prefill
  (``Engine(..., mesh=...).prefill``) of this process's rows;
* ``decode_32k`` / ``long_500k``: the mesh engine's decode step over this
  process's cache slices at the shape's full context.  The step closes a
  chunk in every row: the cache holds ``seq_len - 1`` tokens, which the
  step reads as host-known lengths (``Engine.decode(..., lengths=...)``;
  meta tensors hold no values to read).  The reference's jitted decode
  counts its chunk close's branch too (its cost model takes the larger
  branch of a ``cond``).

The kernel wrappers run their plain versions on meta operands, as the
reference's ops take their XLA paths off the TPU, and compute nothing.  One
trace records:

* ``loop_cost``: this process's FLOPs and bytes
  (:mod:`repro_torch.perf.op_cost`; eager torch runs every loop, so trip
  counts are exact), and ``op_histogram``, its top 15 aten ops by count;
* ``collectives`` / ``collective_bytes``: the collectives it issues, by
  kind (:mod:`repro_torch.perf.comm_stats`);
* ``roofline`` (:mod:`repro_torch.perf.roofline`) of every process doing
  rank 0's work (the count × chips), rank 0's collective operand bytes
  (the reference passes its per-device HLO's), and ``model_flops``;
* ``memory``: this process's bytes of parameters, optimizer state, batch
  and caches by their specs, and the sum of the step's arguments among them
  ``argument_size_in_bytes`` (the twin of XLA's; a prefill's caches are
  its output); ``gathered_peak_bytes``, the most bytes of gathered weight
  copies alive at once (the train step gathers every split weight, the
  engine one layer's at a time: :mod:`repro_torch.dist.whole`).  Compile
  time and XLA's temp, output, alias and peak buffers have no twin:
  nothing is compiled, and meta tensors allocate nothing.

One JSON file per cell lands in ``experiments/dryrun_torch/``; a cell whose
file exists is skipped.  The fake group is built only inside
:func:`dryrun_cell` and destroyed after the cell; it never serves a run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--policy gear_kcvt4]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.core.policy import named_policy
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.transformer import Transformer
from repro_torch.perf.comm_stats import CollectiveCounter
from repro_torch.perf.op_cost import OpCounter, op_histogram
from repro_torch.perf.roofline import model_flops, roofline
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.train.loop import make_train_step
from repro_torch.train.state import RunConfig, init_train_state

__all__ = ["OUT_DIR", "build_cell", "dryrun_cell", "run_cells", "fake_group", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
META = torch.device("meta")
NO_TWIN = ("compile_s", "generated_code_size_in_bytes", "output_size_in_bytes",
           "temp_size_in_bytes", "alias_size_in_bytes", "peak_memory_in_bytes")


# the ``memory`` entries that are a step's arguments (a prefill's caches are
# its output, the gathered weight copies its temporaries)
ARGUMENTS = ("batch_bytes", "param_bytes", "opt_bytes", "cache_bytes")


def input_batch(cfg, shape) -> dict:
    """Meta stand-ins of every model input of a cell (the reference's
    ``input_specs``): the token batch for training and prefill (a VLM's text
    beside its ``img_embeds``, an audio model's codebook frames), one token
    a row for decode."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.mode in ("train", "prefill"):
        if cfg.modality == "vlm":
            p = cfg.num_prefix_tokens
            return {"tokens": torch.empty((B, S - p), dtype=i32, device=META),
                    "img_embeds": torch.empty((B, p, cfg.d_model), dtype=torch.bfloat16,
                                              device=META)}
        if cfg.modality == "audio":
            return {"tokens": torch.empty((B, S, cfg.num_codebooks), dtype=i32, device=META)}
        return {"tokens": torch.empty((B, S), dtype=i32, device=META)}
    if cfg.modality == "audio":
        return {"tokens": torch.empty((B, 1, cfg.num_codebooks), dtype=i32, device=META)}
    return {"tokens": torch.empty((B, 1), dtype=i32, device=META)}


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _batch_bytes(cfg, batch: dict, mesh) -> int:
    """This process's bytes of ``batch`` by ``batch_pspecs``."""
    specs = shd.batch_pspecs(cfg, batch, mesh)
    return _nbytes(shd.Sharding(mesh, specs[k]).local(v) for k, v in batch.items())


def build_cell(arch: str, shape_name: str, mesh, policy_name: str = "gear_kcvt4",
               microbatches: int = 8):
    """Returns (fn, args, memory): the cell's step, its meta arguments, and
    this process's bytes of its parameters, optimizer state, batch and
    caches."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    batch = input_batch(cfg, shape)
    mem = {"batch_bytes": _batch_bytes(cfg, batch, mesh)}
    if shape.mode == "train":
        run = RunConfig(microbatches=microbatches, remat=True, remat_policy="dots", zero1=True,
                        ckpt_every=0)
        state = init_train_state(Transformer(cfg, META, dtype=torch.float32), run, mesh)
        mem["param_bytes"] = _nbytes(state.params.parameters())
        mem["opt_bytes"] = _nbytes(list(state.opt.mu.values()) + list(state.opt.nu.values()))
        step = make_train_step(model, run, mesh)
        mem["gathered_peak_bytes"] = step.whole.gathered_bytes(state.params)
        return step, (state, batch), mem
    policy = named_policy(policy_name)
    eng = Engine(model, Transformer(cfg, META), EngineConfig(
        batch=shape.global_batch, capacity=shape.seq_len, policy=policy), device=META, mesh=mesh)
    mem["param_bytes"] = _nbytes(eng.params.parameters())
    mem["gathered_peak_bytes"] = eng._whole.gathered_bytes(eng.params, by_block=True)
    caches = eng.init_caches()
    if shape.mode == "prefill":
        # the prefill's output: this process's cache slices
        mem["output_cache_bytes"] = eng.cache_nbytes(caches)
        return eng.prefill, (batch,), mem
    mem["cache_bytes"] = eng.cache_nbytes(caches)
    lengths = np.full(shape.global_batch, shape.seq_len - 1, np.int64)

    def decode(b, c):
        return eng.decode(b, c, shape.seq_len - 1, lengths=lengths)

    return decode, (batch, caches), mem


def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    processes: collectives are dispatched and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool, policy_name: str = "gear_kcvt4",
                microbatches: int = 8) -> dict:
    """Trace one cell as rank 0 of the production mesh (see the module
    docstring) and return its record."""
    if dist.is_initialized():
        raise RuntimeError("dryrun_cell builds its own fake process group; this process "
                           "already has one")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = int(np.prod(list(axis_sizes(mesh).values())))
        t0 = time.time()
        fn, args, mem = build_cell(arch, shape_name, mesh, policy_name, microbatches)
        with OpCounter() as ops, CollectiveCounter() as coll:
            fn(*args)
        t_trace = time.time() - t0
    finally:
        dist.destroy_process_group()
    cs = coll.stats()
    loop_cost = {"flops": ops.flops, "bytes": ops.bytes, "matmul_flops": ops.matmul_flops}
    mf = model_flops(cfg, shape)
    rl = roofline(ops.flops * chips, ops.bytes * chips, cs["total_operand_bytes"], chips, mf)
    mem["argument_size_in_bytes"] = sum(mem[k] for k in ARGUMENTS if k in mem)
    return {
        "arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "policy": policy_name, "microbatches": microbatches,
        "trace_s": round(t_trace, 1),
        "loop_cost": loop_cost, "memory": mem, "no_twin": list(NO_TWIN),
        "collectives": {k: v for k, v in cs.items() if k != "total_operand_bytes"},
        "collective_bytes": cs["total_operand_bytes"],
        "roofline": rl.row(),
        "op_histogram": op_histogram(ops.ops),
    }


def run_cells(cells, multi_pod: bool, policy: str, out_dir: str) -> list:
    os.makedirs(out_dir, exist_ok=True)
    results = []
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    for arch, shape_name in cells:
        fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
        if os.path.exists(fname):
            with open(fname) as f:
                results.append(json.load(f))
            print(f"[skip] {arch} × {shape_name} × {mesh_tag} (cached)")
            continue
        try:
            rec = dryrun_cell(arch, shape_name, multi_pod, policy)
            with open(fname, "w") as f:
                json.dump(rec, f, indent=1)
            r = rec["roofline"]
            print(f"[ok]   {arch} × {shape_name} × {mesh_tag}: "
                  f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s → {r['bottleneck']} "
                  f"(trace {rec['trace_s']}s)")
            results.append(rec)
        except Exception as e:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_tag}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=6)
            results.append({"arch": arch, "shape": shape_name, "error": str(e)})
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="gear_kcvt4")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a in ARCHS for s in shapes_for(a)]
    else:
        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else [s.name for s in SHAPES.values()]
        cells = [(a, s) for a in archs for s in shapes
                 if any(sc.name == s for sc in shapes_for(a))]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        run_cells(cells, mp, args.policy, args.out)


if __name__ == "__main__":
    main()
