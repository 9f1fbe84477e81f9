"""K7: fused attention forward with an online softmax, the LM encoder's
attention.

``flash_attention`` is the port of the reference's Pallas kernel of the
same name (``_flash_kernel``): q (B, Sq, Hq, D) against k and v
(B, Sk, Hkv, D), float32 or bf16, float32 inside, q's dtype out. Causal
and sliding-window masks come from absolute positions, ``valid_len``
keeps only key slots [0, valid_len) (with ``window``, only the trailing
``window`` of them), query head h reads kv head h // (Hq // Hkv), and a
row with no key left is 0. On a CUDA tensor it launches the CUDA kernel
(``csrc/flash_attention.cu``: bf16 on the tensor cores with ``wgmma`` for
head dims up to 256, float32 on the CUDA cores, and any head dim above
256 on the CUDA cores in 256-column chunks, bf16 through float32 copies);
on a CPU tensor it runs
``flash_attention_plain``, the same online softmax over kv tiles written
out in torch ops. The two sum in different orders, so they agree to
float32 rounding, not bit for bit (bf16: P enters PV as two bf16 terms,
about 16 significant bits). On a ``meta`` tensor (the roofline's step
counter, ``roofline/counter.py``) it runs neither: it hands the call to
each callable in ``META_SINKS``, which charges ``flash_work``'s FLOPs
and bytes, and returns an empty output.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "META_SINKS", "NEG_INF",
           "SUPPORTED_HEAD_DIMS", "flash_attention", "flash_attention_plain",
           "flash_work"]

# kernel launches so far (bumped where the kernel is launched, nowhere else)
LAUNCHES = {"flash_attention": 0}
# callables (q, k, causal, window, valid_len) told of every call on the
# meta device, where no kernel runs (the roofline counter adds its own)
META_SINKS = []

NEG_INF = -1e30
# the reference kernel's kv tile (``DEFAULT_KV_BLK``): the plain version
# accumulates over kv tiles of this many keys, as the Pallas kernel does
KV_BLK = 1024
# the kernel's instantiation widths: a head dim D runs on the smallest one
# >= D, with zero columns past D (routing only); above the last, the wide
# float32 instantiation takes any D in 256-column chunks
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
MAX_HEAD_DIM = SUPPORTED_HEAD_DIMS[-1]
_DTYPES = (torch.float32, torch.bfloat16)


def _key_range(q_pos, Sk: int, causal: bool, window: int, valid_len):
    """(lo, hi): the keys lo <= k < hi that each query keeps, the one
    definition of K7's masks (``q_pos`` holds query positions, a numpy
    array or a tensor, and the bounds are of its kind and shape)."""
    lo = q_pos * 0
    hi = lo + Sk
    if valid_len is not None:
        hi = hi.clip(max=valid_len)
        if window > 0:
            lo = lo.clip(min=valid_len - window)
    if causal:
        hi = hi.clip(max=q_pos + 1)
    if window > 0 and valid_len is None:
        lo = lo.clip(min=q_pos - window + 1)
    return lo, hi


def _keep(q_pos, k_pos, Sk: int, causal: bool, window: int, valid_len):
    """(Sq, nk) bool: which keys each query keeps (the reference's ``ok``)."""
    lo, hi = _key_range(q_pos, Sk, causal, window, valid_len)
    return (k_pos >= lo) & (k_pos < hi)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          valid_len=None):
    """The plain PyTorch version: (B, Sq, Hq, D) x (B, Sk, Hkv, D) ->
    (B, Sq, Hq, D) in q's dtype, accumulated in float32 over kv tiles of
    ``KV_BLK`` keys with the reference kernel's masks and running
    (m, l, acc)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    vl = None if valid_len is None else int(valid_len)
    # (B, Hkv, G, Sq, D) queries against (B, Hkv, 1, Sk, D) keys and values
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    blk = max(1, min(KV_BLK, Sk))
    for k0 in range(0, Sk, blk):
        k1 = min(k0 + blk, Sk)
        k_pos = torch.arange(k0, k1, device=dev)[None, :]
        ok = _keep(q_pos, k_pos, Sk, causal, window, vl)
        if not bool(ok.any()):
            continue                     # a fully masked tile changes nothing
        s = torch.matmul(qf, kf[..., k0:k1, :].transpose(-1, -2)) * D ** -0.5
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vf[..., k0:k1, :])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def flash_work(q, k, *, causal: bool = True, window: int = 0,
               valid_len=None):
    """(FLOPs, bytes) of one K7 call: the QK^T and PV multiply-adds, 4 D
    FLOPs for each (batch, query head) over the (query, key) pairs that the
    masks keep (``_key_range``, on numpy positions: no torch op runs), and
    q and the output moved once, k and v over their valid key slots (with
    ``valid_len``, the first min(Sk, valid_len) slots), in q's element
    size. Only shapes are read."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    vl = None if valid_len is None else int(valid_len)
    lo, hi = _key_range(np.arange(Sq), Sk, causal, window, vl)
    pairs = int((hi - lo).clip(min=0).sum())
    keys = k.numel() if vl is None else k.numel() // Sk * min(Sk, vl)
    return (4.0 * D * B * Hq * pairs,
            float((2 * q.numel() + 2 * keys) * q.element_size()))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D)")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads")


def _launch(lib, q, k, v, out, causal: bool, window: int, valid_len,
            stream: int) -> None:
    D = q.shape[-1]
    if D < 1:
        raise ValueError(f"head dim {D}: the kernel takes D >= 1")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes {_DTYPES}, got {q.dtype}")
    if q.dtype == torch.bfloat16:
        if D > MAX_HEAD_DIM:
            # the wide float32 kernel on float32 copies, rounded back once
            outf = torch.empty(q.shape, dtype=torch.float32, device=q.device)
            _launch_rows(lib, q.float(), k.float(), v.float(), outf, D,
                         causal, window, valid_len, stream)
            out.copy_(outf)
            return
        if D % 8:
            # TMA's row strides must be multiples of 16 bytes: run on copies
            # zero-padded to a multiple of 8 columns, with the scale of D
            Dp = -(-D // 8) * 8
            qp, kp, vp = (torch.nn.functional.pad(t, (0, Dp - D))
                          for t in (q, k, v))
            outp = torch.empty_like(qp)
            _launch_rows(lib, qp, kp, vp, outp, D, causal, window, valid_len,
                         stream)
            out.copy_(outp[..., :D])
            return
        for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: bf16 operands must start on a "
                                 "16-byte boundary (the kernel's TMA "
                                 "copies need it)")
    _launch_rows(lib, q, k, v, out, D, causal, window, valid_len, stream)


def _launch_rows(lib, q, k, v, out, head_dim: int, causal: bool, window: int,
                 valid_len, stream: int) -> None:
    """Launch on rows of width q.shape[-1] >= ``head_dim`` (the columns past
    it zeros), with the scale of ``head_dim``."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    dev = q.device
    ptrs = [
        _build.require(q, "q", None, dev, q.dtype),
        _build.require(k, "k", None, dev, q.dtype),
        _build.require(v, "v", None, dev, q.dtype),
        _build.require(out, "out", tuple(q.shape), dev, q.dtype),
    ]
    vl = -1 if valid_len is None else max(0, int(valid_len))
    _build.call(lib, "flash_attention", ptrs,
                [B, Sq, Sk, Hq, Hkv, D, int(q.dtype == torch.bfloat16),
                 int(bool(causal)), int(window), vl, head_dim], stream)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    valid_len=None):
    """Fused attention forward: (B, Sq, Hq, D) queries against
    (B, Sk, Hkv, D) keys and values -> (B, Sq, Hq, D) in q's dtype.
    ``valid_len`` (an int or a one-element tensor) keeps only key slots
    [0, valid_len)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     valid_len=valid_len)
    if q.device.type == "meta":
        for sink in META_SINKS:
            sink(q, k, causal, window, valid_len)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = torch.empty_like(q)
    if out.numel():
        _launch(_build.load("flash_attention"), q, k, v, out, causal, window,
                valid_len, _build.stream_of(q.device))
        LAUNCHES["flash_attention"] += 1
    return out
