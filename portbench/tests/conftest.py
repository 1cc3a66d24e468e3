"""Puts the repository's ``src`` and root on the path for the benchmark's
tests (run with ``python -m pytest portbench/tests`` from the root)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
