"""LLaVA-Plus in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``llava_plus_tpu`` (JAX), which stays the reference: same module
names, same parameter trees, outputs held against it in the tests. This
package imports nothing of JAX and nothing of ``llava_plus_tpu``: what it
needs of the JAX package's framework-free modules (configs, data planning,
tokenizers, the prefix-cache hashing, the HTTP worker) it keeps as its own
copies, so either package can be read, changed or removed on its own.

Kernels live in ``csrc/`` and are built at first use by ``kernels/build.py``;
each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
for CPU tensors.
"""
