"""K1: grouped candidate verification with the row gather fused in, and
K6: one query against a block of codes.

``gather_verify_grouped`` is the port of the reference's gather +
``verify_tuples_grouped`` launch (the Pallas kernel body
``_verify_grouped_kernel`` and the ``jnp.take`` row gather of
``_gather_verify_grouped_impl``): for query ``b`` and candidate slot
``c < lengths[b]`` the packed key ``r10 * (p + 1) + r01`` of code
``db[cand_idx[b, c]]``, and -1 in every padded slot. On a CUDA tensor it
launches the CUDA kernel (``csrc/verify_grouped.cu``); on a CPU tensor it
runs ``gather_verify_grouped_plain``, the same function in plain PyTorch.
The keys are exact integers, so kernel and plain version agree exactly.

``verify_tuples`` is the port of the reference's Pallas kernel of the same
name (``_verify_kernel``): one (W,) query against (N, W) codes -> the
exact tuples (r10, r01), each (N,) int32, from ``csrc/verify_tuples.cu``
on a CUDA tensor and from ``verify_tuples_plain`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import verify_tuples_grouped_ref, verify_tuples_ref

__all__ = ["LAUNCHES", "gather_verify_grouped", "gather_verify_grouped_plain",
           "verify_tuples", "verify_tuples_plain"]

# kernel launches so far (bumped where the kernel is launched, nowhere else)
LAUNCHES = {"verify_grouped": 0, "verify_tuples": 0}


def gather_verify_grouped_plain(q_words, db_words, cand_idx, lengths, p: int):
    """(B, W), (N, W), (B, C), (B,) int32 -> (B, C) int32 packed keys."""
    cand = db_words[cand_idx.long()]                 # (B, C, W)
    return verify_tuples_grouped_ref(q_words, cand, lengths, p)


def _launch(lib, q_words, db_words, cand_idx, lengths, out, p: int,
            stream: int) -> None:
    B, W = q_words.shape
    C = cand_idx.shape[1]
    dev = q_words.device
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel's grid rows (65535)")
    ptrs = [
        _build.require(q_words, "q_words", (B, W), dev),
        _build.require(db_words, "db_words", (db_words.shape[0], W), dev),
        _build.require(cand_idx, "cand_idx", (B, C), dev),
        _build.require(lengths, "lengths", (B,), dev),
        _build.require(out, "out", (B, C), dev),
    ]
    # vector row loads where every row is aligned for them; other codes
    # take the scalar-load instantiation
    addr = db_words.data_ptr()
    vec = (W == 2 and addr % 8 == 0) or (W in (4, 8) and addr % 16 == 0)
    _build.call(lib, "verify_grouped", ptrs, [B, C, W, p, vec], stream)


def gather_verify_grouped(q_words, db_words, cand_idx, lengths, *, p: int):
    """Packed bucket keys of the candidates ``db_words[cand_idx]``:
    (B, W), (N, W), (B, C), (B,) int32 -> (B, C) int32. Candidate rows are
    gathered inside the kernel: only the index matrix crosses to it."""
    if q_words.device.type == "cpu":
        return gather_verify_grouped_plain(
            q_words, db_words, cand_idx, lengths, p
        )
    if q_words.device.type != "cuda":
        raise ValueError(f"no kernel for device {q_words.device}")
    out = torch.empty(cand_idx.shape, dtype=torch.int32,
                      device=q_words.device)
    _launch(_build.load("verify_grouped"), q_words, db_words, cand_idx,
            lengths, out, p, _build.stream_of(q_words.device))
    LAUNCHES["verify_grouped"] += 1
    return out


def verify_tuples_plain(q_words, cand_words):
    """(W,), (N, W) int32 -> (r10, r01), each (N,) int32."""
    return verify_tuples_ref(q_words, cand_words)


def _launch_one(lib, q_words, cand_words, r10, r01, stream: int) -> None:
    (W,) = q_words.shape
    N = cand_words.shape[0]
    dev = q_words.device
    if W > 8:
        raise ValueError(f"W={W} words exceeds the kernel's 8 (p <= 256)")
    ptrs = [
        _build.require(q_words, "q_words", (W,), dev),
        _build.require(cand_words, "cand_words", (N, W), dev),
        _build.require(r10, "r10", (N,), dev),
        _build.require(r01, "r01", (N,), dev),
    ]
    _build.call(lib, "verify_tuples", ptrs, [N, W], stream)


def verify_tuples(q_words, cand_words):
    """Exact tuples of one query against every code of a block:
    (W,), (N, W) int32 -> (r10, r01), each (N,) int32."""
    if q_words.device.type == "cpu":
        return verify_tuples_plain(q_words, cand_words)
    if q_words.device.type != "cuda":
        raise ValueError(f"no kernel for device {q_words.device}")
    N = cand_words.shape[0]
    r10 = torch.empty(N, dtype=torch.int32, device=q_words.device)
    r01 = torch.empty(N, dtype=torch.int32, device=q_words.device)
    if N:
        _launch_one(_build.load("verify_tuples"), q_words, cand_words, r10,
                    r01, _build.stream_of(q_words.device))
        LAUNCHES["verify_tuples"] += 1
    return r10, r01
