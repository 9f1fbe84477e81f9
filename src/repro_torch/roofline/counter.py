"""The FLOPs, HBM bytes and peak memory of one step, counted on ``meta``
tensors: the port's counterpart of the reference's "compile the step,
then ``parse_hlo_costs``" (eager PyTorch compiles no HLO to parse).

``count_step(cfg, shape)`` builds the step's arguments on the ``meta``
device at full width, allocating nothing: the parameters from
``param_specs``, the optimizer state from ``state_specs``, the batch from
``input_specs`` and, for a decode step, a cache from ``init_cache``. It
runs the step (``make_train_step``, the prefill, or ``make_serve_step``
with one token against a cache of ``seq_len`` positions) under
``StepCounter``, a ``TorchDispatchMode`` that sees every aten op:

- **FLOPs**: the matmul and convolution FLOPs (``torch.utils.flop_counter``'s
  formulas), as the parser counts ``dot`` and ``convolution``; K7, which
  runs nothing on ``meta``, reports ``flash_work``'s count through
  ``kernels.flash_attention.META_SINKS`` (4 D FLOPs a (batch, query
  head) over the (query, key) pairs its masks keep).
- **HBM bytes**: eager torch's traffic model. Every op that launches a
  kernel reads its tensor operands and writes its outputs (each operand
  counted over the distinct elements it spans, so a broadcast view costs
  its storage; a copy or fill does not read its destination). View and
  alias ops, allocations and metadata ops are free, as the parser's
  ``_FREE_OPS`` are. Unlike XLA's fusions, every op reads and writes HBM.
  K7 moves q and o once and k and v over their valid slots.
- **Scopes**: bytes are bucketed by the reference's ``named_scope`` names,
  planted in the port as ``torch.profiler.record_function`` ranges
  (``flash_attn``, ``decode_attn``, ``mlp``, ``moe``, ``ssd``, ``adamw``,
  ``ce_loss``). A backward op takes the scope of the forward op whose
  autograd node runs it (by the node's sequence number), then the ranges
  open around it (``flash_attn_bwd``, a remat recompute's).
- **Collective bytes**: 0 on one card.
- **Bytes per device**: the arguments' storages (the parameters, the
  optimizer state, the batch, the cache), plus the peak of the live
  storages that the step's ops allocate. What the step updates in place
  (the parameters and moments under AdamW, the cache under decode)
  allocates nothing and is counted once, as an argument.

The counter is host code: it moves no data and reads no value (a step
that calls ``.item()`` or branches on a tensor fails on ``meta``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attention import META_SINKS, flash_work
from ..models.api import Model, input_specs
from ..models.common import ArchConfig, ShapeConfig
from ..optim import OptimConfig
from ..train.step import make_serve_step, make_train_step
from ..tree import tree_map
from .hlo_parse import _SCOPE_TAGS, HloCosts

__all__ = ["Counted", "StepCounter", "count", "count_step"]

_aten = torch.ops.aten
# a record_function range opens and closes through these two ops
_RF_ENTER = torch.ops.profiler._record_function_enter_new
_RF_EXIT = torch.ops.profiler._record_function_exit
# ops that launch no kernel, beside those whose schema returns a view:
# allocations and aliases
_FREE = {
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten._unsafe_view.default,
}
# in-place ops that write their first operand without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}
# where this torch lacks them, backward ops take only the ranges open
# around them
_seq_nr = getattr(torch._C._autograd, "_get_sequence_nr", None)
_current_node = getattr(torch._C, "_current_autograd_node", None)


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input it does not write
    (its schema's view annotation, as ``OpOverload.is_view`` reads it)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _scope_tag(path: str) -> str:
    for tag in _SCOPE_TAGS:
        if tag in path:
            return tag
    return "other"


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads from operand ``t``: its distinct elements (a
    dimension of stride 0 is one element wide)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """Counts every aten op run while it is active (see the module
    docstring): ``costs`` (an ``HloCosts``), ``kernels`` (ops that
    launch a kernel on the card; K7 counts one), ``ranges`` (the
    ``record_function`` ranges entered) and ``peak_bytes`` (the most
    bytes of storages allocated inside, alive at once)."""

    def __init__(self):
        super().__init__()
        self.costs = HloCosts()
        self.kernels = 0
        self.ranges = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._ranges: List[str] = []
        self._node_scope: Dict[int, str] = {}
        self._last_seq: Optional[int] = None
        self._seen: Dict[int, weakref.finalize] = {}

    # -- scopes
    def _path(self) -> str:
        parts = []
        node = _current_node() if _current_node is not None else None
        if node is not None:
            parts.append(self._node_scope.get(node._sequence_nr(), ""))
        parts.extend(self._ranges)
        return "/".join(p for p in parts if p)

    def _charge(self, path: str, name: str, flops: float,
                nbytes: float) -> None:
        c = self.costs
        self.kernels += 1
        c.hbm_bytes += nbytes
        tag = _scope_tag(path)
        c.hbm_bytes_by_scope[tag] = c.hbm_bytes_by_scope.get(tag, 0.0) \
            + nbytes
        if flops:
            c.flops += flops
            key = f"{path}/{name}" if path else name
            c.dot_flops_by_meta[key] = c.dot_flops_by_meta.get(key, 0.0) \
                + flops

    # -- memory
    def _allocated(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._seen[key] = weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self._seen.pop(key, None)
        self.live_bytes -= n

    def known(self, tensors) -> None:
        """Mark storages that exist before the step (its arguments), so
        that ops writing into them are not counted as allocations."""
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key not in self._seen:
                self._seen[key] = weakref.finalize(st, self._seen.pop, key,
                                                   None)

    # -- K7
    def _flash(self, q, k, causal, window, valid_len) -> None:
        flops, nbytes = flash_work(q, k, causal=causal, window=window,
                                   valid_len=valid_len)
        self._charge(self._path(), "flash_attention", flops, nbytes)

    def __enter__(self):
        META_SINKS.append(self._flash)
        self._last_seq = _seq_nr() if _seq_nr is not None else None
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            META_SINKS.remove(self._flash)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket is _RF_ENTER:
            self.ranges += 1
            self._ranges.append(args[0])
            return func(*args, **kwargs)
        if func.overloadpacket is _RF_EXIT:
            self._ranges.pop()
            return func(*args, **kwargs)
        path = self._path()
        seq = _seq_nr() if _seq_nr is not None else None
        out = func(*args, **kwargs)
        if seq is not None and seq != self._last_seq:
            # the number moved: this op created a node, numbered seq - 1
            # (an op that creates none leaves the last node's scope alone)
            self._node_scope[seq - 1] = path
            self._last_seq = seq
        outs = _tensors(out)
        self._allocated(outs)
        if not outs or func in _FREE or _is_view(func):
            return out
        reads = _tensors((args[1:] if func in _WRITE_ONLY else args,
                          {k: v for k, v in kwargs.items() if k != "out"}))
        nbytes = sum(_read_bytes(t) for t in reads) + sum(
            t.numel() * t.element_size() for t in outs)
        flops = 0.0
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
        self._charge(path, str(func.overloadpacket).split(".")[-1], flops,
                     float(nbytes))
        return out


@dataclass
class Counted:
    """One counted call: its ``costs``, the bytes of its arguments'
    storages, the peak of the storages it allocated alive at once, the
    ops that launch a kernel and the ``record_function`` ranges it
    entered."""

    costs: HloCosts
    arg_bytes: float
    peak_bytes: float
    kernels: int
    ranges: int

    @property
    def bytes_per_device(self) -> float:
        return self.arg_bytes + self.peak_bytes


def _storage_bytes(tensors) -> float:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return float(sum(seen.values()))


def count(fn: Callable, *args) -> Counted:
    """Run ``fn(*args)`` (on ``meta`` tensors, or any) under a
    ``StepCounter`` and return what it counted."""
    arg_tensors = _tensors(args)
    counter = StepCounter()
    counter.known(arg_tensors)
    with counter:
        out = fn(*args)
    del out
    return Counted(costs=counter.costs, arg_bytes=_storage_bytes(arg_tensors),
                   peak_bytes=float(counter.peak_bytes),
                   kernels=counter.kernels, ranges=counter.ranges)


def _fresh(tree):
    """A copy of a tree of meta tensors with one storage a leaf (the
    specs may share one tensor between leaves, as ``state_specs`` does
    between the two moments)."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree,
                    torch.is_tensor)


def count_step(cfg: ArchConfig, shape: ShapeConfig, *,
               ocfg: OptimConfig = OptimConfig(),
               pos: Optional[int] = None) -> Counted:
    """Count one step of ``cfg`` at ``shape`` on the ``meta`` device:

    train:   ``make_train_step(cfg, ocfg)``'s step (one microbatch, no
             gradient compression) on the batch of ``input_specs`` (the
             loss, its gradients, AdamW in place);
    prefill: ``Model.prefill`` on that batch, under ``no_grad``;
    decode:  ``make_serve_step(cfg)``'s step: one token a row at position
             ``pos`` (default ``seq_len - 1``) of a cache of ``seq_len``
             positions (a hybrid's ring holds min(seq_len, window) of
             them)."""
    dev = torch.device("meta")
    model = Model(cfg)
    params = _fresh(model.param_specs())
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        ts = make_train_step(cfg, ocfg, device=dev)
        opt = _fresh(ts["opt_specs"])
        return count(ts["step"], params, opt, batch)
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, device=dev)

        return count(prefill, params, batch)
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=dev)
    step = make_serve_step(cfg, device=dev)["step"]
    pos = shape.seq_len - 1 if pos is None else pos
    return count(lambda p, c, t: step(p, c, t, pos), params, cache,
                 batch["tokens"])

