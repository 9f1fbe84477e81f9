"""PyTorch and CUDA port of the AMIH exact angular search (``repro`` is
the JAX reference it is held against).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
The port so far: the main path — exact top-K angular search with AMIH on
one device, ``make_engine("amih", db, p)`` (the device walk by default)
-> ``knn_batch`` -> ``(ids, sims, EngineStats)`` — its host walk, and
three hand-written CUDA kernels (``kernels/csrc``). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""

from .core import (
    AMIHIndex,
    AMIHStats,
    EngineStats,
    available_backends,
    make_engine,
)

__all__ = [
    "AMIHIndex",
    "AMIHStats",
    "EngineStats",
    "available_backends",
    "make_engine",
]
