"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates.

Frozen copy of the data-sheet figures in ``repro_torch.perf.roofline.HW``
(bf16 tensor cores, HBM3) and of ``chip_smoke.py``'s f32 rate; the
benchmark keeps its own copy so that a change to the program cannot move
its yardstick.  They assume the card's full 700 W power limit; every run
prints the card's limit beside its numbers.
"""

BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12          # f32 FLOP/s outside the tensor cores (an FMA counts 2)
HBM_BYTES_PER_S = 3.35e12  # HBM3 bytes/s
