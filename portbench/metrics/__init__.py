"""One reader a per-layer metric, found by the metric's name.

``portbench/metrics/<name>.py`` defines ``read(ctx)``: the metric's value
from a traced run's context (:class:`portbench.run.Context`), or None where
the run holds nothing for it to read, in which case the result line leaves
the metric out.  A reader never returns 0 for a share of a roofline or peak.
"""

import importlib


def reader(name: str):
    """The ``read`` function of metric ``name``: ``portbench/metrics/<name>.py``."""
    return importlib.import_module(f"portbench.metrics.{name}").read
