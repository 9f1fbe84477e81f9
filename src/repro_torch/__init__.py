"""PyTorch and CUDA port of the AMIH exact angular search (``repro`` is
the JAX reference it is held against).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
The port: exact top-K angular search with AMIH on the card,
``make_engine("amih", db, p)`` (the device walk by default) ->
``knn_batch`` -> ``(ids, sims, EngineStats)``, its host walk, the linear
scan and the single table; the shard, pipeline and cluster layers and
observability; retrieval serving, token serving and training on the
dense LMs (gemma-2b, llama3-8b, granite-3-8b, granite-34b: ``serve``,
``models``, ``configs``, ``optim``, ``checkpoint``, ``train``,
``launch.serve``, ``launch.train``); the reference's four examples
(``examples``); the roofline of one card (``roofline``: a step's FLOPs
and bytes counted on ``meta`` tensors, the reference's analysis). Its
seven hand-written CUDA kernel libraries live in ``kernels/csrc``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
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
