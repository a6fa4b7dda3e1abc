"""PyTorch/CUDA port of the submodular exemplar-clustering system.

Mirrors the module layout of the JAX package (``repro``) so that each module
has an obvious counterpart. Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a hand-written CUDA C++ kernel for Hopper under
``csrc/``, built at first use by :mod:`repro_torch.kernels._build`.
"""
