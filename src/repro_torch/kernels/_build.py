"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(a ``csrc/*.cuh`` header may hold bodies that several sources share):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

into the git-ignored ``kernels/build/`` directory.  The output name carries a
hash of the source, the headers and the flags, so an edited source is never
served a stale library.  :func:`build_all` starts one ``nvcc`` per source, all at once.
Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on
a non-zero code.
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

__all__ = ["CSRC", "BUILD", "nvcc", "build_all", "load", "check", "KernelError"]

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD = pathlib.Path(__file__).with_name("build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code} at launch")
