"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level names; the reference loads nothing of the program."""

import ast
import pathlib
import subprocess
import sys

from portbench.run import FORBIDDEN, forbidden_modules

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core.cache", "reproduce",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "functools", "math", "numpy", "torch",
                                  "portbench"}, path
    for path in HERE.rglob("*.py"):
        assert not (_imports(path) & set(FORBIDDEN)), path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv = ['x']; import runpy; "
            "m = runpy.run_path('portbench/run.py', run_name='not_main'); "
            "import portbench.calibrate, repro_torch.serving.engine, repro_torch.models.model; "
            "print(m['forbidden_modules']())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "minicpm-2b.batch-prefill", "--seed", str(2 ** 31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
