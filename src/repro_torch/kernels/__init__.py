"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions, and the launch layer.

- verify_tuples: K1, grouped candidate verification with the row gather
  fused in (the host walk's ``verify_backend="cuda"``)
- device_probe: K2, the fused probing walk (one launch per batch), and
  K3, its exhaustive fallback scan
- flash_attention: K7, the fused attention forward of the LM encoder
- ops: padding, placement, launch counters and the position-map pool
- ref: plain PyTorch popcount and verify (the CPU path and the oracle)
- _build: nvcc build and ctypes loading of the kernel libraries

Importing this package compiles nothing: a kernel is built the first time
a CUDA tensor reaches its wrapper.
"""

from . import device_probe, flash_attention, ops, ref, verify_tuples

__all__ = ["device_probe", "flash_attention", "ops", "ref", "verify_tuples"]
