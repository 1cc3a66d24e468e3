"""Analytic performance bounds (port of ``repro.perf``): the three-term
roofline and the useful FLOPs of a step (:mod:`repro_torch.perf.roofline`)."""
