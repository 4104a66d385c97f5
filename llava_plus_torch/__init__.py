"""LLaVA-Plus in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``llava_plus_tpu`` (JAX), which stays the reference: same module
names, same parameter trees, outputs held against it in the tests. Modules
of the JAX package that do not use JAX (configs, data planning, tokenizers,
the HTTP worker) are imported from it, not copied. This package never
imports JAX.

Kernels live in ``csrc/`` and are built at first use by ``kernels/build.py``;
each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
for CPU tensors.
"""
