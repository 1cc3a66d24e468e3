"""Atomic checkpoints of a :class:`~repro_torch.train.state.TrainState`
(port of ``repro.ckpt.checkpoint``).

Layout:  <dir>/step_<N>/
             manifest.json       — leaf names, shapes, dtypes, sha1 hashes
             arr_<i>.npy         — one file per leaf
             _COMMITTED          — written last; restore ignores dirs without it

The leaves are flattened in one fixed order: every parameter of
``state.params`` (``named_parameters()`` order) as ``params.<name>``, then
``opt.mu.<name>`` and ``opt.nu.<name>`` in the same order, ``opt.count``,
``step``, and the PowerSGD error feedback ``ef.<name>`` where there is one.

* **atomic**: the manifest and leaves land in a temporary directory that is
  renamed into place, and ``_COMMITTED`` is written last, so a preempted
  save is never half-restored;
* **verified**: :func:`restore` refuses a leaf whose sha1 differs from the
  manifest's before it writes anything;
* **async**: :func:`save_async` copies to the host synchronously and writes
  on a background thread; :func:`wait_pending` joins the writes and raises
  the first error one of them met;
* **mesh-independent**: on a mesh (``shardings``: the state's
  :func:`~repro_torch.train.state.train_state_shardings`) each leaf is
  gathered into its global array, rank 0 writes and the other processes
  wait on a barrier; :func:`restore` slices each global array onto
  whatever mesh the restarted job has (elastic rescale).  The PowerSGD
  error feedback, which differs between pods, is stored as rank 0's.

A bf16 leaf is stored as its 16-bit pattern (numpy has no bf16) and the
manifest records ``bfloat16``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending"]

_PENDING: list[concurrent.futures.Future] = []
_LOCK = threading.Lock()


def _leaves(state) -> list:
    """(name, tensor) of every leaf of ``state`` in the checkpoint's order."""
    names = [n for n, _ in state.params.named_parameters()]
    out = [(f"params.{n}", p.detach()) for n, p in state.params.named_parameters()]
    out += [(f"opt.mu.{n}", state.opt.mu[n]) for n in names]
    out += [(f"opt.nu.{n}", state.opt.nu[n]) for n in names]
    out += [("opt.count", torch.tensor(state.opt.count, dtype=torch.int32)),
            ("step", torch.tensor(state.step, dtype=torch.int32))]
    if state.ef is not None:
        out += [(f"ef.{n}", state.ef[n]) for n in names if n in state.ef]
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _to_host(t: torch.Tensor) -> tuple:
    """(numpy array, dtype name) of a tensor; bf16 as its int16 bit pattern."""
    t = t.detach().cpu()
    arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return arr, _dtype_name(t.dtype)


def _by_name(shardings) -> dict:
    """Each sharded leaf's :class:`~repro_torch.dist.sharding.Sharding`, by
    leaf name (the error feedback and the host integers are whole)."""
    out = {f"params.{n}": sh for n, sh in shardings.params.items()}
    out.update({f"opt.mu.{n}": sh for n, sh in shardings.opt.mu.items()})
    out.update({f"opt.nu.{n}": sh for n, sh in shardings.opt.nu.items()})
    return out


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_leaves(state, shardings=None) -> list:
    """(name, array, dtype) of every leaf, global arrays on a mesh (every
    process takes part in the gathers; only the writer keeps the copies)."""
    shs = {} if shardings is None else _by_name(shardings)
    out = []
    for name, t in _leaves(state):
        if name in shs and not shs[name].trivial:
            t = shs[name].full(t)
        if _writer():
            out.append((name, *_to_host(t)))
    return out


def _barrier(shardings) -> None:
    if shardings is not None and dist.get_world_size() > 1:
        dist.barrier()


def save(ckpt_dir: str, step: int, state, shardings=None) -> str:
    """Write ``state`` (on a mesh: with its ``shardings``) as checkpoint
    ``step``; returns its directory."""
    host = _host_leaves(state, shardings)
    final = _write(ckpt_dir, step, host) if _writer() else _final(ckpt_dir, step)
    _barrier(shardings)
    return final


def save_async(ckpt_dir: str, step: int, state, shardings=None) -> None:
    """:func:`save` with the host copy made now and the write (rank 0's) on
    a thread."""
    host = _host_leaves(state, shardings)
    if not _writer():
        return
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(_write, ckpt_dir, step, host)
    pool.shutdown(wait=False)
    with _LOCK:
        _PENDING.append(future)


def wait_pending() -> None:
    """Wait for every :func:`save_async` write; raise the first error."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for future in pending:
        future.result()


def _final(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _write(ckpt_dir: str, step: int, host_leaves: list) -> str:
    final = _final(ckpt_dir, step)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype) in enumerate(host_leaves):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape), "dtype": dtype,
                                   "sha1": hashlib.sha1(arr.tobytes()).hexdigest()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    with open(os.path.join(final, "_COMMITTED"), "w") as f:
        f.write("ok")
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The largest committed step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "_COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, state, shardings=None):
    """Load checkpoint ``step`` into ``state``'s tensors (in place, on their
    devices; on a mesh, each process's slice of each global array by
    ``shardings``) and return the state with the checkpoint's ``step`` and
    ``opt.count``.  Raises ``IOError`` for a corrupt leaf and ``ValueError``
    for a checkpoint of another tree (names, shapes or dtypes), before
    anything is written."""
    d = _final(ckpt_dir, step)
    shs = {} if shardings is None else _by_name(shardings)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(state)
    metas = manifest["leaves"]
    if [n for n, _ in leaves] != [m["name"] for m in metas]:
        raise ValueError(f"checkpoint {d} holds another tree than this state")
    arrays = []
    for i, (meta, (name, leaf)) in enumerate(zip(metas, leaves)):
        arr = np.load(os.path.join(d, f"arr_{i}.npy"))
        if hashlib.sha1(arr.tobytes()).hexdigest() != meta["sha1"]:
            raise IOError(f"checkpoint leaf {i} ({name}) corrupt")
        if name in shs:
            arr = shs[name].local(torch.from_numpy(arr)).numpy()
        if list(arr.shape) != list(leaf.shape) or meta["dtype"] != _dtype_name(leaf.dtype):
            raise ValueError(f"checkpoint leaf {name} is {meta['dtype']} {arr.shape}, "
                             f"expected {leaf.dtype} {tuple(leaf.shape)}")
        arrays.append(arr)
    scalars = {}
    with torch.no_grad():
        for (name, leaf), meta, arr in zip(leaves, metas, arrays):
            t = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if name in ("opt.count", "step"):
                scalars[name] = int(t)
            else:
                leaf.copy_(t)
    opt = dataclasses.replace(state.opt, count=scalars["opt.count"])
    return dataclasses.replace(state, opt=opt, step=scalars["step"])
