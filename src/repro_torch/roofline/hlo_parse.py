"""Structural parser for XLA optimized HLO text (the port's own copy of
the reference's ``roofline/hlo_parse.py``; it imports only ``json``,
``re`` and ``dataclasses``).

In the port, ``HloCosts`` is also the record that the torch step counter
(``counter.py``) fills: eager PyTorch compiles no HLO, so the counter
measures a step's FLOPs and HBM bytes op by op, and the parser stays to
read the text the reference compiles, so the two can be held side by
side. What follows is the reference's account of the parser.

Why this exists: ``compiled.cost_analysis()`` visits every while-loop body
ONCE — a 61-layer ``lax.scan`` stack is undercounted ~61x, which would make
every roofline number garbage. XLA *does* annotate each while op with
``backend_config={"known_trip_count":{"n":...}}`` in optimized HLO, so this
module rebuilds costs structurally:

  1. split the module into computations,
  2. resolve every op's output shape (operands are ``%name`` references),
  3. walk the call graph from ENTRY, multiplying by while trip counts,
  4. accumulate, per computation multiplicity:
       - matmul FLOPs from ``dot``/``convolution`` ops
         (2 x prod(output) x prod(contracted lhs dims)),
       - an HBM-traffic model: for every top-level op that is not free
         (parameter/constant/tuple/get-tuple-element/bitcast/...), bytes =
         operand bytes + output bytes. Fusion internals are excluded — a
         fusion op is one read-inputs/write-outputs kernel, exactly the
         roofline model of fused execution,
       - collective bytes by op kind (all-reduce / all-gather /
         reduce-scatter / all-to-all / collective-permute), operand sizes.

Shapes in optimized SPMD HLO are PER-DEVICE shards, so every number this
parser emits is per-device; analysis.py turns them into aggregate terms.

The parser is validated against cost_analysis() on scan-free modules (where
cost_analysis is correct) in tests/test_roofline.py, and the copy against
the reference's parser in tests/test_torch_roofline.py.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["HloCosts", "parse_hlo_costs"]

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "f8e8m0fnu": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0, "opaque": 0, "tuple": 0,
}

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")

# ops that cost nothing (aliasing / metadata / control)
_FREE_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "rng-get-and-update-state",
    "opt-barrier", "domain", "add-dependency",
}
# ops whose cost is their callees' (recursed), not the op line itself
_CONTROL_OPS = {"while", "conditional", "call", "async-start", "async-done"}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# named_scope tags planted by the model code (models/layers.py,
# models/blocks.py, models/ssm.py, optim/adamw.py); the port plants the same
# names as ``torch.profiler.record_function`` ranges
_SCOPE_TAGS = (
    "flash_attn", "decode_attn", "moe", "mlp", "ssd", "adamw", "ce_loss",
)


@dataclass
class _Op:
    name: str
    kind: str
    out_shapes: List[Tuple[str, Tuple[int, ...]]]
    operand_names: List[str]
    attrs: str                       # raw trailing attribute text


@dataclass
class _Computation:
    name: str
    ops: List[_Op] = field(default_factory=list)


@dataclass
class HloCosts:
    """Per-device costs of one compiled module (trip-count scaled)."""

    flops: float = 0.0                       # matmul/conv FLOPs
    hbm_bytes: float = 0.0                   # modeled HBM traffic
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_ops: Dict[str, int] = field(default_factory=dict)
    n_whiles: int = 0
    trip_counts: List[int] = field(default_factory=list)
    dot_flops_by_meta: Dict[str, float] = field(default_factory=dict)
    # HBM bytes bucketed by named_scope tag found in op metadata
    # (flash_attn / moe / mlp / ssd / adamw / <other>)
    hbm_bytes_by_scope: Dict[str, float] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _shape_bytes(dtype: str, dims: Tuple[int, ...]) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    n = 1
    for d in dims:
        n *= d
    return n * b


def _parse_shapes(text: str) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for m in _SHAPE_RE.finditer(text):
        dims = tuple(int(x) for x in m.group(2).split(",") if x)
        out.append((m.group(1), dims))
    return out


def _balanced(text: str, start: int) -> int:
    """Index just past the paren group opening at ``start`` ('(')."""
    depth = 0
    for i in range(start, len(text)):
        c = text[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


_OP_LINE_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*")


def _parse_op_line(line: str) -> Optional[_Op]:
    m = _OP_LINE_RE.match(line)
    if m is None:
        return None
    name = m.group(1)
    rest = line[m.end():]
    # output shape: tuple '(...)' or single token
    if rest.startswith("("):
        end = _balanced(rest, 0)
        out_txt = rest[:end]
        rest = rest[end:].lstrip()
    else:
        sp = rest.find(" ")
        out_txt = rest[:sp]
        rest = rest[sp + 1:]
    out_shapes = _parse_shapes(out_txt)
    km = re.match(r"([\w\-]+)\(", rest)
    if km is None:
        return None
    kind = km.group(1)
    args_end = _balanced(rest, km.end() - 1)
    args_txt = rest[km.end(): args_end - 1]
    attrs = rest[args_end:]
    operands = re.findall(r"%([\w.\-]+)", args_txt)
    return _Op(name, kind, out_shapes, operands, attrs)


def _split_computations(text: str) -> Tuple[List[_Computation], str]:
    """Parse all computations; returns (computations, entry_name)."""
    comps: List[_Computation] = []
    entry = ""
    cur: Optional[_Computation] = None
    for line in text.splitlines():
        stripped = line.strip()
        hdr = re.match(
            r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{", stripped
        )
        if hdr and not line.startswith(" " * 2):
            cur = _Computation(name=hdr.group(2))
            comps.append(cur)
            if hdr.group(1):
                entry = cur.name
            continue
        if stripped == "}":
            # computation end (op lines are indented; braces in op lines
            # never sit alone on a line)
            continue
        if cur is not None and "%" in stripped and "=" in stripped:
            op = _parse_op_line(line)
            if op is not None:
                cur.ops.append(op)
    return comps, entry


def _trip_count(op: _Op) -> int:
    m = re.search(r'"known_trip_count":\{"n":"?(\d+)"?\}', op.attrs)
    if m:
        return int(m.group(1))
    return 1


def _callee(op: _Op, key: str) -> Optional[str]:
    m = re.search(key + r"=%([\w.\-]+)", op.attrs)
    return m.group(1) if m else None


def _dot_flops(
    op: _Op, shapes: Dict[str, List[Tuple[str, Tuple[int, ...]]]]
) -> float:
    out_elems = 1
    for _, dims in op.out_shapes:
        for d in dims:
            out_elems *= d
    lhs = shapes.get(op.operand_names[0]) if op.operand_names else None
    contracted = 1
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
    if lhs and m and m.group(1):
        lhs_dims = lhs[0][1]
        for idx in (int(x) for x in m.group(1).split(",")):
            if idx < len(lhs_dims):
                contracted *= lhs_dims[idx]
    return 2.0 * out_elems * contracted


def _conv_flops(
    op: _Op, shapes: Dict[str, List[Tuple[str, Tuple[int, ...]]]]
) -> float:
    # 2 * output elements * (kernel spatial x input channels)
    out_elems = 1
    for _, dims in op.out_shapes:
        for d in dims:
            out_elems *= d
    rhs = shapes.get(op.operand_names[1]) if len(op.operand_names) > 1 else None
    k = 1
    if rhs:
        for d in rhs[0][1]:
            k *= d
        # divide by output-feature dim (approx: kernel = spatial*in_c*out_c)
        out_c = rhs[0][1][-1] if rhs[0][1] else 1
        k = max(1, k // max(out_c, 1))
    return 2.0 * out_elems * k


def parse_hlo_costs(hlo_text: str) -> HloCosts:
    comps, entry = _split_computations(hlo_text)
    by_name = {c.name: c for c in comps}

    # pass 1: global op-name -> output shapes (names are unique module-wide)
    shapes: Dict[str, List[Tuple[str, Tuple[int, ...]]]] = {}
    for c in comps:
        for op in c.ops:
            shapes[op.name] = op.out_shapes

    # pass 2: computation multiplicities from the call graph
    mult: Dict[str, float] = {entry: 1.0}
    order = [entry]
    # breadth-first; while/call/conditional create edges
    i = 0
    while i < len(order):
        cname = order[i]
        i += 1
        comp = by_name.get(cname)
        if comp is None:
            continue
        m = mult[cname]
        for op in comp.ops:
            edges: List[Tuple[str, float]] = []
            if op.kind == "while":
                tc = _trip_count(op)
                body = _callee(op, "body")
                cond = _callee(op, "condition")
                if body:
                    edges.append((body, m * tc))
                if cond:
                    edges.append((cond, m * (tc + 1)))
            elif op.kind == "conditional":
                for br in re.findall(
                    r"(?:branch_computations=\{([^}]*)\}|true_computation=%([\w.\-]+)|false_computation=%([\w.\-]+))",
                    op.attrs,
                ):
                    for g in br:
                        if not g:
                            continue
                        for nm in re.findall(r"%?([\w.\-]+)", g):
                            edges.append((nm, m))
            elif op.kind == "call":
                to = _callee(op, "to_apply")
                if to:
                    edges.append((to, m))
            for tgt, tm in edges:
                if tgt in mult:
                    mult[tgt] += tm
                else:
                    mult[tgt] = tm
                    order.append(tgt)

    costs = HloCosts()
    for c in comps:
        m = mult.get(c.name)
        if m is None:
            continue  # fusion body / reduce applier: not HBM-visible
        for op in c.ops:
            if op.kind == "while":
                costs.n_whiles += 1
                costs.trip_counts.append(_trip_count(op))
            if op.kind in _FREE_OPS or op.kind in _CONTROL_OPS:
                continue
            out_bytes = sum(_shape_bytes(t, d) for t, d in op.out_shapes)
            in_bytes = 0
            for nm in op.operand_names:
                for t, d in shapes.get(nm, []):
                    in_bytes += _shape_bytes(t, d)
            op_bytes = m * (out_bytes + in_bytes)
            costs.hbm_bytes += op_bytes
            scope = "other"
            meta = re.search(r'op_name="([^"]*)"', op.attrs)
            if meta:
                path = meta.group(1)
                for tag in _SCOPE_TAGS:
                    if tag in path:
                        scope = tag
                        break
            costs.hbm_bytes_by_scope[scope] = (
                costs.hbm_bytes_by_scope.get(scope, 0.0) + op_bytes
            )

            base = op.kind.replace("-start", "")
            if base in _COLLECTIVES:
                costs.collective_bytes[base] = (
                    costs.collective_bytes.get(base, 0.0) + m * in_bytes
                )
                costs.collective_ops[base] = (
                    costs.collective_ops.get(base, 0) + 1
                )
            elif op.kind == "dot":
                f = m * _dot_flops(op, shapes)
                costs.flops += f
                meta = re.search(r'op_name="([^"]*)"', op.attrs)
                key = meta.group(1) if meta else op.name
                costs.dot_flops_by_meta[key] = (
                    costs.dot_flops_by_meta.get(key, 0.0) + f
                )
            elif op.kind == "convolution":
                costs.flops += m * _conv_flops(op, shapes)
    return costs
