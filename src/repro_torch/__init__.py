"""PyTorch/CUDA port of the GEAR serving system (``repro`` is the JAX reference).

The subpackages mirror the reference's (``configs``, ``core``, ``kernels``,
``models``, ``serving``) module for module.  Hot-path kernels are CUDA C++
for Hopper (``kernels/csrc``), built with ``nvcc`` at first use; every
kernel has a plain PyTorch version beside it, which CPU tensors take.
"""
