"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions, and the launch layer.

- verify_tuples: K1, grouped candidate verification with the row gather
  fused in (the host walk's ``verify_backend="cuda"``), and K6, one query
  against a block of codes
- hamming_scan: K4, the linear scan's scores and its fused top-K
- blockmax_scan: K5, the pruned scan's block maxima
- device_probe: K2, the fused probing walk (one launch per batch), and
  K3, its exhaustive fallback scan
- flash_attention: K7, the fused attention forward of the LM encoder
- ops: padding, placement, launch counters and the position-map pool
- ref: plain PyTorch popcount and verify (the CPU path and the oracle)
- _build: nvcc build and ctypes loading of the kernel libraries

Importing this package compiles nothing: a kernel is built the first time
a CUDA tensor reaches its wrapper.

The package binds the reference's names (``repro.kernels``): the five
kernel functions, ``ops`` and ``ref``. ``flash_attention`` and
``verify_tuples`` are then the functions, not their modules; reach a
module with ``importlib.import_module("repro_torch.kernels.<name>")`` or
import names from it (``from repro_torch.kernels.flash_attention import
...``).
"""

from . import device_probe, ops, ref
from .blockmax_scan import blockmax_scores
from .flash_attention import flash_attention
from .hamming_scan import hamming_scan_scores
from .verify_tuples import verify_tuples, verify_tuples_grouped

__all__ = [
    "blockmax_scores",
    "flash_attention",
    "hamming_scan_scores",
    "ops",
    "ref",
    "verify_tuples",
    "verify_tuples_grouped",
]
