#!/usr/bin/env python
"""Where the scan backward's time goes, on the card: builds of
``csrc/linear_scan.cu`` with one part of the owner block's work cut out,
timed beside the whole at paths 25-26's training shapes.

    python3 scripts/scan_bwd_parts.py      # from the repository root, on an H100

Each build is this tree's source with one edit, compiled beside the tree's
kernels into the git-ignored ``kernels/build/parts/``:

* ``whole``: the source as it is;
* ``no_epilogue``: the owners' epilogue cut (dr, dk, d log w and du are not
  written);
* ``no_k_state``: the owners' k_state pass cut;
* ``no_cross``: the owners' g S_c^T and v G^T products cut;
* ``no_mma``: every ``mma.sync`` replaced by one scalar op on its operands
  (the operand loads and splits stay).

A cut build computes wrong gradients; only its time means something.  Prints
each build's call time (``chip_smoke.time_ms``, cold L2) and its CUDA
kernels' times (a profiler window).  An edit that no longer finds its text
in the source stops the script.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

CUTS = {
    "no_epilogue": [("  if (!OWNER) return;\n\n  // the owner's epilogue",
                     "  return;\n\n  // the owner's epilogue")],
    "no_k_state": [("  if (OWNER) {                      // k_state of tile j over k_fac",
                    "  if (false) {                      // k_state of tile j over k_fac")],
    "no_cross": [("      if (OWNER && s_c != nullptr)\n        mma_row<4>(acc_dq",
                  "      if (false)\n        mma_row<4>(acc_dq"),
                 ("      if (OWNER) {\n        frag_a(ah, al, vs + m0 * BLD",
                  "      if (false) {\n        frag_a(ah, al, vs + m0 * BLD")],
}


def sources(out: pathlib.Path) -> dict:
    """Write each build's linear_scan.cu (and, for no_mma, its header) under
    out/<name>/; returns {name: source path}."""
    src = (_build.CSRC / "linear_scan.cu").read_text()
    header = (_build.CSRC / "mma_tf32.cuh").read_text()
    texts = {"whole": (src, header)}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"scan_bwd_parts: {name}'s cut no longer matches the source")
            text = text.replace(old, new)
        texts[name] = (text, header)
    start = header.index("__device__ __forceinline__ void mma_tf32(")
    end = header.index("\n}\n", start) + 3
    texts["no_mma"] = (src, header[:start] + (
        "__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, "
        "const uint32_t* b) {\n  d[0] += __uint_as_float(a[0] ^ b[0]) * 1e-30f;\n}\n")
        + header[end:])
    paths = {}
    for name, (text, hdr) in texts.items():
        (out / name).mkdir(parents=True, exist_ok=True)
        (out / name / "linear_scan.cu").write_text(text)
        (out / name / "mma_tf32.cuh").write_text(hdr)
        paths[name] = out / name / "linear_scan.cu"
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_parts: no CUDA device", file=sys.stderr)
        return 2
    print(cs.smi())
    out = _build.BUILD / "parts"
    procs = {}
    for name, path in sources(out).items():
        lib = path.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    builds = {name: cs.parent_scan(proc, lib)[1] for name, (proc, lib) in procs.items()}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cs.DEV)
    for key, case in cs.SCAN_BWD_TRAIN_CASES.items():
        mode, BH, S, Dk, Dv, lw_cols, chunk, _ = case
        r, k, v, lw, u = cs.scan_inputs(mode, BH, S, Dk, Dv, lw_cols, S + Dk)
        gen = torch.Generator(device=cs.DEV).manual_seed(S + Dv)
        kw = dict(chunk=chunk, mode=mode, dstate=torch.zeros(BH, Dk, Dv, device=cs.DEV),
                  dy=torch.randn(BH, S, Dv, generator=gen, device=cs.DEV))
        for name, fn in builds.items():
            call = (lambda f: lambda: f(r, k, v, lw, u, **kw))(fn)
            ms = cs.time_ms(call, 20, flush)
            kernels = cs.kernel_breakdown(call, 10, flush)
            print(f"{key} {name}: {ms:.4f} ms; "
                  + ", ".join(f"{n} {t:.4f}" for n, t in kernels.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
