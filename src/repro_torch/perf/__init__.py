"""Analytic performance bounds and counts (port of ``repro.perf``): the
three-term roofline and the useful FLOPs of a step
(:mod:`repro_torch.perf.roofline`), the FLOPs and bytes of a traced step
(:mod:`repro_torch.perf.op_cost`, the twin of ``jaxpr_cost``) and its
collectives (:mod:`repro_torch.perf.comm_stats`, the twin of ``hlo_stats``)."""
