"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over every
process of the job, with the reference's axis names and order: ``(data,
model)``, or ``(pod, data, model)``.  One process drives one device; the
processes come from ``torchrun`` (``torchrun --nproc-per-node N -m ...``),
which sets ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``; a process started
without them is a job of one.  The backend is NCCL on CUDA and gloo on the
CPU.  A mesh whose size is not the job's world size raises, naming the
world size it needs: nothing trains on fewer processes than the mesh asks.

The spec rules (:mod:`repro_torch.dist.sharding`) read only a mesh's axis
names and sizes (:func:`axis_sizes`), so tests pass a stand-in with a
``shape`` mapping, as the reference's do.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device

__all__ = ["make_production_mesh", "make_test_mesh", "dp_axes", "axis_sizes", "mesh_device",
           "DATA", "MODEL", "POD"]

POD, DATA, MODEL = "pod", "data", "model"


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _make_mesh(shape: tuple, names: tuple, device):
    dev = resolve_device(device)
    need = math.prod(shape)
    world = _world_size()
    if world != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} ({', '.join(names)}) mesh needs a world size of "
            f"{need}, and this job has {world}: start {need} processes, e.g. "
            f"`torchrun --nproc-per-node {need} -m repro_torch.launch.train ...`")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)          # torchrun's env:// rendezvous
        else:                                         # a job of one: no rendezvous
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 (data, model) on 256 processes, or 2×16×16 (pod, data, model)
    on 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (POD, DATA, MODEL) if multi_pod else (DATA, MODEL)
    return _make_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, device=None):
    """A ``data × model`` mesh (``pod × data × model`` when ``pod``) on
    ``device``'s type: CUDA unless the caller names the CPU."""
    if pod:
        return _make_mesh((pod, data, model), (POD, DATA, MODEL), device)
    return _make_mesh((data, model), (DATA, MODEL), device)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a stand-in's
    ``shape`` mapping, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in axis_sizes(mesh) if a in (POD, DATA))


def mesh_device(mesh) -> torch.device:
    """The device this process drives on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
