"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(a ``csrc/*.cuh`` header may hold bodies that several sources share):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -Xptxas --split-compile=0 \
         -o build/lib<name>-<hash>.so csrc/<name>.cu

into the git-ignored ``kernels/build/`` directory.  The output name carries a
hash of the source, the headers and the flags, so an edited source is never
served a stale library.  :func:`build_all` starts one ``nvcc`` per source, all at once.
Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
a non-zero code.

A kernel is called through ``ctypes`` on raw pointers, so autograd does not
see it: its outputs are new leaves and every gradient above them would read
zero.  The serving kernels take no gradient (training attends through
``models.attention.attention_train``), so each of their wrappers calls
:func:`refuse_grad` before it launches.  ``linear_scan_chunked`` has a
backward kernel instead, behind an ``autograd.Function``
(``linear_scan_kernel``): RWKV6 and hymba train through it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

__all__ = ["CSRC", "BUILD", "nvcc", "build_all", "load", "check", "refuse_grad",
           "KernelError"]

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD = pathlib.Path(__file__).with_name("build")
# ptxas compiles a source's kernels on every CPU (--split-compile=0): on the
# H100 host it built gear_decode.cu in 65.7 s against 82.9 s, to the same SASS
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-Xptxas", "--split-compile=0")


class KernelError(RuntimeError):
    """A kernel failed to build or its launch reported a CUDA error."""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))   # shared bodies
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def build_all(names=None) -> dict:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    current library, one ``nvcc`` process each, in parallel.  Returns
    ``{name: (seconds, ptxas log)}`` for the sources it compiled."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)          # atomic: a concurrent build sees all or nothing
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    build_all([name])
    return ctypes.CDLL(str(_target(name)))


def runs_plain(x: torch.Tensor) -> bool:
    """Whether ``x``'s device takes a kernel's plain version: the CPU, and
    the meta device, where the dry run (``repro_torch.launch.dryrun``)
    traces the port's step and counts its operations without computing (the
    twin of the reference's dry run, whose ops take their XLA paths off the
    TPU).  A CUDA tensor launches the kernel; any other device raises."""
    return x.device.type in ("cpu", "meta")


def refuse_grad(who: str, operands, hint: str = "", on_cuda: bool | None = None) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an operand on CUDA
    requires grad: a serving kernel has no backward, and its call would cut
    the autograd graph without a word.  ``on_cuda`` overrides the device
    test (the CPU tests pass True).  Serving runs under
    ``torch.inference_mode``, where grad mode is off."""
    if not torch.is_grad_enabled():
        return
    for x in operands:
        if isinstance(x, torch.Tensor) and x.requires_grad and (
                x.is_cuda if on_cuda is None else on_cuda):
            raise RuntimeError(
                f"{who}: an operand requires grad, and this serving kernel has no backward "
                "(training attends through models.attention.attention_train); its call "
                "would cut the autograd graph" + (f"; {hint}" if hint else ""))


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code} at launch")
