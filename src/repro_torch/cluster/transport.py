"""Length-prefixed TCP framing for the cross-host serving tier (a copy
of the reference's ``cluster/transport.py``: the frames are byte for byte
the reference's, so port and reference coordinators and workers talk to
each other).

One frame = MAGIC, a big-endian uint32 header length, a JSON header, and
the raw bytes of zero or more C-contiguous numpy arrays back to back:

    +------+-----------+----------------+---------------------------+
    | AMRP | hdr_len   | JSON header    | array 0 bytes | array 1 … |
    +------+-----------+----------------+---------------------------+

The header carries the frame ``kind`` (the protocol verb — see
docs/cluster.md for the full verb table), any JSON-serializable ``meta``
fields, and an ``arrays`` list of ``{name, dtype, shape}`` descriptors
in payload order — enough to slice every array back out of the payload
without pickling anything. stdlib + numpy only: ``socket``, ``struct``
and ``json`` are the whole dependency surface.

Reads loop until the requested byte count arrives (TCP is a byte
stream; short reads are normal) and raise ``FrameError`` on EOF
mid-frame, oversized declarations, or a bad magic — a coordinator
treats any of those as the peer being gone. Writes go through
``sendall`` under the caller's per-socket lock, so heartbeat, bound,
and result frames from different threads never interleave mid-frame.

Ragged per-query planes (the bounded search returns a different row
count per query) travel as a (concatenated values, per-query lengths)
pair — ``pack_ragged``/``unpack_ragged``.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FrameError",
    "MAGIC",
    "pack_ragged",
    "recv_exact",
    "recv_frame",
    "send_frame",
    "unpack_ragged",
]

MAGIC = b"AMRP"

# Fail-fast guards against a corrupt or hostile length prefix: a real
# header is a few KB of JSON; a real payload is query words + O(K)
# result planes. Way above both, way below an allocation bomb.
MAX_HEADER = 1 << 24       # 16 MiB
MAX_PAYLOAD = 1 << 31      # 2 GiB

_LEN = struct.Struct(">I")

# dtypes the protocol ships; anything else is a programming error on the
# sending side, caught before bytes hit the wire.
_WIRE_DTYPES = frozenset({
    "uint8", "uint32", "uint64", "int32", "int64", "float32", "float64",
})


class FrameError(ConnectionError):
    """The peer vanished mid-frame or sent bytes that are not a frame."""


def recv_exact(sock: socket.socket, nbytes: int) -> bytearray:
    """Read exactly ``nbytes`` (looping over partial reads). Raises
    FrameError on EOF before the count is met — a half-delivered frame
    means the peer died, never a recoverable state. Returns a bytearray
    so numpy views over it are writable."""
    buf = bytearray(nbytes)
    view = memoryview(buf)
    got = 0
    while got < nbytes:
        r = sock.recv_into(view[got:], nbytes - got)
        if r == 0:
            raise FrameError(
                f"connection closed mid-frame ({got}/{nbytes} bytes)"
            )
        got += r
    return buf


def send_frame(
    sock: socket.socket,
    kind: str,
    meta: Optional[Dict[str, Any]] = None,
    arrays: Optional[Dict[str, np.ndarray]] = None,
    lock=None,
) -> None:
    """Serialize and send one frame. ``arrays`` values are forced
    C-contiguous; dtypes outside the wire set raise before any byte is
    sent. ``lock`` (a threading.Lock) spans the whole write so frames
    from concurrent senders (heartbeat vs bound vs result threads)
    never interleave."""
    header: Dict[str, Any] = {"kind": kind}
    if meta:
        header.update(meta)
    chunks: List[bytes] = []
    descr: List[Dict[str, Any]] = []
    for name, arr in (arrays or {}).items():
        arr = np.ascontiguousarray(arr)
        if str(arr.dtype) not in _WIRE_DTYPES:
            raise ValueError(
                f"array {name!r} has non-wire dtype {arr.dtype}"
            )
        descr.append({
            "name": name,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        })
        chunks.append(arr.tobytes())
    header["arrays"] = descr
    hdr = json.dumps(header, separators=(",", ":")).encode()
    if len(hdr) > MAX_HEADER:
        raise ValueError(f"header too large: {len(hdr)} bytes")
    payload = b"".join(chunks)
    frame = MAGIC + _LEN.pack(len(hdr)) + hdr + payload
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def recv_frame(
    sock: socket.socket, timeout: Optional[float] = None
) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Receive one frame -> (kind, meta, arrays). ``timeout`` bounds the
    wait for the frame's FIRST byte (socket.timeout propagates to the
    caller); once a frame has started arriving, the remainder is read
    without a deadline — a peer that stalls mid-frame is caught by the
    heartbeat layer, not here."""
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        magic = recv_exact(sock, len(MAGIC))
    finally:
        if timeout is not None:
            sock.settimeout(None)
    if bytes(magic) != MAGIC:
        raise FrameError(f"bad frame magic {bytes(magic)!r}")
    (hdr_len,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if hdr_len > MAX_HEADER:
        raise FrameError(f"declared header of {hdr_len} bytes")
    try:
        header = json.loads(bytes(recv_exact(sock, hdr_len)))
    except ValueError as e:
        raise FrameError(f"undecodable frame header: {e}") from None
    descr = header.pop("arrays", [])
    total = 0
    for d in descr:
        if str(d["dtype"]) not in _WIRE_DTYPES:
            raise FrameError(f"non-wire dtype {d['dtype']!r} declared")
        try:
            dims = [int(x) for x in d["shape"]]
        except (TypeError, ValueError) as e:
            raise FrameError(f"undecodable shape declared: {e}") from None
        if any(x < 0 for x in dims):
            # a negative dim makes np.prod negative, which would slip
            # under MAX_PAYLOAD and reach np.frombuffer as a bad count
            raise FrameError(f"negative dimension in declared shape {dims}")
        d["shape"] = dims
        total += int(np.prod(dims, dtype=np.int64)) * \
            np.dtype(d["dtype"]).itemsize
    if total > MAX_PAYLOAD:
        raise FrameError(f"declared payload of {total} bytes")
    payload = recv_exact(sock, total) if total else bytearray()
    arrays: Dict[str, np.ndarray] = {}
    off = 0
    for d in descr:
        dt = np.dtype(d["dtype"])
        shape = tuple(int(x) for x in d["shape"])
        size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        arrays[d["name"]] = np.frombuffer(
            payload, dtype=dt, count=int(np.prod(shape, dtype=np.int64)),
            offset=off,
        ).reshape(shape)
        off += size
    kind = header.pop("kind", "")
    return kind, header, arrays


# ---------------------------------------------------------- ragged planes
def pack_ragged(
    planes: Sequence[np.ndarray], dtype=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query ragged arrays -> (concatenated values, int64 lengths).
    The inverse of ``unpack_ragged``; an all-empty list round-trips to
    a (0,) values array."""
    lens = np.array([p.shape[0] for p in planes], dtype=np.int64)
    if planes:
        flat = np.concatenate([np.asarray(p) for p in planes])
    else:
        flat = np.empty(0, dtype=dtype or np.float64)
    if dtype is not None:
        flat = flat.astype(dtype, copy=False)
    return flat, lens


def unpack_ragged(
    flat: np.ndarray, lens: np.ndarray
) -> List[np.ndarray]:
    """(values, lengths) -> per-query list; validates that the lengths
    consume the values array exactly."""
    lens = np.asarray(lens, dtype=np.int64)
    if int(lens.sum()) != flat.shape[0]:
        raise FrameError(
            f"ragged lengths sum to {int(lens.sum())}, "
            f"payload has {flat.shape[0]} values"
        )
    out: List[np.ndarray] = []
    off = 0
    for ln in lens:
        out.append(flat[off : off + int(ln)])
        off += int(ln)
    return out
