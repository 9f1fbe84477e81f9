"""ShardPlan: the row-partition layout of a packed-code DB split into
shards (a port of the reference's ``shard/plan.py``).

One plan answers every layout question the sharded engines ask:

  - which global rows shard ``s`` holds (balanced remainder: shard sizes
    differ by at most one row, never a trailing empty shard),
  - the per-shard global-id offset (``starts[s]``) that turns a shard's
    local row index into a DB-wide id,
  - the common padded row count (``rows_padded``) of the device layout —
    every shard occupies an equal-size slice of a (S * rows_padded, W)
    array; pad rows are zero codes that the scan masks out via per-shard
    ``counts`` (``ops.scan_topk``'s ``n_valid``),
  - which DEVICE owns shard ``s`` (``devices`` / ``device_for``): a
    ``torch.device`` per shard, where the sharded engines place the
    shard's codes and run its launches,
  - a JSON-serializable ``summary()`` (and ``from_summary`` inverse) so a
    serving fleet can ship the layout next to the index (device
    assignments serialize as strings, for observability only — a fresh
    host re-derives its own placement via ``place``/``from_mesh``;
    ``from_summary(strict=True)`` turns that documented drop into an
    error for callers that must not lose placement silently).

torch has no device mesh, so the mesh helpers take an explicit one:
``DeviceMesh(devices, axis_names)`` lays an explicit device list out over
named axes (``make_device_mesh``), and ``resolve_mesh_axes``,
``devices_from_mesh`` and ``ShardPlan.from_mesh`` read it as the
reference reads its mesh. ``balanced(n, num_shards)`` covers host-side
sharding; ``place(devices)`` assigns an explicit device list round-robin
(wrapping when there are fewer devices than shards — one card holds every
shard).

``host_partition(num_hosts)`` hands each host a sub-plan over a
contiguous run of the parent's shards, with ``base`` recording the
global id of the sub-plan's local row 0 — ``starts`` stay GLOBAL ids
while ``shard_slice`` indexes the host's LOCAL row array.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "DeviceMesh",
    "ShardPlan",
    "devices_from_mesh",
    "make_device_mesh",
    "resolve_mesh_axes",
]


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """An explicit device mesh: ``devices`` is an object array of
    ``torch.device``s whose dimensions are the named ``axis_names``
    (torch has none of its own; this carries what the sharded scan and
    ``ShardPlan.from_mesh`` read of a device mesh)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if np.asarray(self.devices).ndim != len(self.axis_names):
            raise ValueError(
                f"devices have {np.asarray(self.devices).ndim} dims, "
                f"axis_names {self.axis_names}"
            )

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, np.asarray(self.devices).shape))


def make_device_mesh(devices, shape=None,
                     axis_names: Tuple[str, ...] = ("data",)) -> DeviceMesh:
    """A ``DeviceMesh`` over an explicit device list (strings or
    ``torch.device``s), reshaped to ``shape`` (default: one axis)."""
    import torch

    flat = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        flat[i] = torch.device(d)
    if shape is None:
        shape = (len(devices),)
    return DeviceMesh(flat.reshape(shape), tuple(axis_names))


def resolve_mesh_axes(mesh, shard_axes=None):
    """(axes, n_shards) for the mesh axes DB rows shard across: the
    requested axes filtered to ones the mesh has (default: every mesh
    axis), and the product of their sizes. The single source of this
    rule — used by both ShardPlan.from_mesh and shard/distributed.py,
    which must agree on the shard count."""
    axes = tuple(shard_axes) if shard_axes is not None \
        else tuple(mesh.axis_names)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    n_shards = 1
    for a in axes:
        n_shards *= mesh.shape[a]
    return axes, n_shards


def devices_from_mesh(mesh, shard_axes=None) -> Tuple[object, ...]:
    """One owner device per shard, in linear shard-index order (row-major
    over the shard axes). When the shard axes are a strict subset of the
    mesh axes, each shard's group of devices is represented by its first
    device."""
    axes, n_shards = resolve_mesh_axes(mesh, shard_axes)
    names = list(mesh.axis_names)
    perm = [names.index(a) for a in axes] + [
        i for i, a in enumerate(names) if a not in axes
    ]
    dev = np.transpose(np.asarray(mesh.devices), perm).reshape(n_shards, -1)
    return tuple(dev[:, 0])


@dataclass(frozen=True)
class ShardPlan:
    """Balanced row partition of ``n`` DB rows into ``num_shards`` shards.

    ``devices`` (when non-empty) is the per-shard placement map: entry
    ``s`` is the ``torch.device`` shard ``s``'s codes live on and its
    launches run on. It is excluded from equality/serialization
    round-trips — placement is a property of the serving host, not of
    the layout contract.

    ``base`` is the global DB id of the plan's local row 0 (0 for a
    whole-DB plan). Sub-plans cut by ``host_partition`` carry the
    offset of their host's first row here: ``starts`` remain GLOBAL
    ids (``n`` and ``counts`` stay host-local), so engines built over
    the host's local row slice still emit DB-wide ids without any
    merge-time fixup.
    """

    n: int
    starts: Tuple[int, ...]
    counts: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ()
    devices: Tuple[object, ...] = field(default=(), compare=False)
    base: int = 0

    def __post_init__(self):
        if len(self.starts) != len(self.counts) or not self.starts:
            raise ValueError("starts/counts must be equal-length, non-empty")
        if sum(self.counts) != self.n:
            raise ValueError(
                f"counts sum to {sum(self.counts)}, expected n={self.n}"
            )
        if self.starts[0] != self.base:
            raise ValueError(
                f"starts[0]={self.starts[0]} must equal base={self.base} "
                f"(starts are global ids; base is the global id of local "
                f"row 0)"
            )
        if self.devices and len(self.devices) != len(self.counts):
            raise ValueError(
                f"devices maps {len(self.devices)} shards, plan has "
                f"{len(self.counts)}"
            )

    # -------------------------------------------------------- constructors
    @classmethod
    def balanced(
        cls,
        n: int,
        num_shards: int,
        axis_names: Tuple[str, ...] = (),
    ) -> "ShardPlan":
        """Partition ``n`` rows into ``num_shards`` contiguous slices whose
        sizes differ by at most one (the first ``n % num_shards`` shards
        take the extra row)."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        base, rem = divmod(n, num_shards)
        counts = tuple(
            base + (1 if s < rem else 0) for s in range(num_shards)
        )
        starts = tuple(int(x) for x in np.cumsum((0,) + counts[:-1]))
        return cls(n=n, starts=starts, counts=counts,
                   axis_names=tuple(axis_names))

    @classmethod
    def from_mesh(
        cls,
        mesh,
        n: int,
        shard_axes: Optional[Tuple[str, ...]] = None,
    ) -> "ShardPlan":
        """Plan over the product of the ``DeviceMesh`` axes the DB rows
        shard across (default: every mesh axis, matching
        ``sharded_scan_topk``). The per-shard ``devices`` map is derived
        from the mesh too (``devices_from_mesh``)."""
        axes, num_shards = resolve_mesh_axes(mesh, shard_axes)
        if not axes:
            raise ValueError(
                f"no shard axes among mesh axes {tuple(mesh.axis_names)}"
            )
        plan = cls.balanced(n, num_shards, axis_names=axes)
        return plan.place(devices_from_mesh(mesh, axes))

    # ----------------------------------------------------------- placement
    def place(self, devices) -> "ShardPlan":
        """A copy of this plan with ``devices`` assigned round-robin over
        the shards: shard ``s`` gets ``devices[s % len(devices)]``, so
        fewer devices than shards wraps (devices host several shards —
        the 1-device host maps every shard to it, exactly the pre-placed
        behavior) and extra devices are simply left idle. An empty/None
        list clears the placement."""
        devices = tuple(devices or ())
        if not devices:
            return replace(self, devices=())
        return replace(self, devices=tuple(
            devices[s % len(devices)] for s in range(self.num_shards)
        ))

    def device_for(self, s: int):
        """Shard ``s``'s assigned device (None when the plan is unplaced
        — callers fall back to the default device)."""
        return self.devices[s] if self.devices else None

    # -------------------------------------------------------- partitioning
    def host_partition(self, num_hosts: int) -> List["ShardPlan"]:
        """Split this plan into ``num_hosts`` per-host sub-plans, each
        covering a contiguous run of the parent's shards (run lengths
        differ by at most one shard). Sub-plan ``starts`` keep the
        parent's GLOBAL ids and ``base`` records the global id of the
        host's first row, so a worker that loads only its local row
        slice (``[base, base + n)`` of the parent DB) still emits
        DB-wide ids — the coordinator merges without any offset fixup.
        Device placements are not carried: each host re-derives its own
        via ``place``/``from_mesh``."""
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        if num_hosts > self.num_shards:
            raise ValueError(
                f"num_hosts={num_hosts} exceeds num_shards="
                f"{self.num_shards}; a host needs at least one shard"
            )
        per, rem = divmod(self.num_shards, num_hosts)
        plans: List[ShardPlan] = []
        s0 = 0
        for h in range(num_hosts):
            run = per + (1 if h < rem else 0)
            starts = self.starts[s0 : s0 + run]
            counts = self.counts[s0 : s0 + run]
            plans.append(ShardPlan(
                n=int(sum(counts)),
                starts=starts,
                counts=counts,
                axis_names=self.axis_names,
                base=int(starts[0]),
            ))
            s0 += run
        return plans

    # ------------------------------------------------------------ geometry
    @property
    def num_shards(self) -> int:
        return len(self.counts)

    @property
    def rows_padded(self) -> int:
        """Common per-shard row count of the padded device layout."""
        return max(self.counts) if self.counts else 0

    def shard_slice(self, s: int) -> slice:
        """Shard ``s``'s rows in the plan's LOCAL row array (for a
        whole-DB plan, local == global; a ``host_partition`` sub-plan
        subtracts ``base`` so it slices the host's own row slab)."""
        lo = self.starts[s] - self.base
        return slice(lo, lo + self.counts[s])

    def global_ids(self, s: int, local_ids: np.ndarray) -> np.ndarray:
        return np.asarray(local_ids) + self.starts[s]

    def padded_layout(self, db_words: np.ndarray) -> np.ndarray:
        """(n, W) -> (num_shards * rows_padded, W): shard ``s`` occupies
        rows [s * rows_padded, (s+1) * rows_padded), its real rows first,
        zero-code pad rows after. The sharded scan masks pads via
        ``counts`` (``scan_topk``'s ``n_valid``), so they never reach a
        top-K."""
        db = np.asarray(db_words)
        R = self.rows_padded
        out = np.zeros((self.num_shards * R,) + db.shape[1:], dtype=db.dtype)
        for s in range(self.num_shards):
            out[s * R : s * R + self.counts[s]] = db[self.shard_slice(s)]
        return out

    # -------------------------------------------------------- serialization
    def summary(self) -> Dict[str, object]:
        """JSON-serializable description (round-trips via from_summary;
        device assignments serialize as strings and are observability
        only — ``from_summary`` returns an unplaced plan)."""
        out = {
            "n": self.n,
            "num_shards": self.num_shards,
            "rows_padded": self.rows_padded,
            "starts": list(self.starts),
            "counts": list(self.counts),
            "axis_names": list(self.axis_names),
        }
        if self.base:
            out["base"] = self.base
        if self.devices:
            out["devices"] = [str(d) for d in self.devices]
        return out

    @classmethod
    def from_summary(
        cls, d: Dict[str, object], strict: bool = False
    ) -> "ShardPlan":
        """Rebuild a plan from ``summary()`` output. Device placements do
        NOT round-trip (they serialize as strings, for observability) —
        the result is always unplaced. A summary that recorded a
        placement triggers a warning, or a ValueError with
        ``strict=True`` for callers that must not lose placement
        silently."""
        if "devices" in d:
            msg = (
                "ShardPlan.from_summary drops device placements "
                f"({len(d['devices'])} recorded): device strings cannot "
                "be resolved to live devices on a different host — "
                "re-place via ShardPlan.place or from_mesh"
            )
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
        return cls(
            n=int(d["n"]),
            starts=tuple(int(x) for x in d["starts"]),
            counts=tuple(int(x) for x in d["counts"]),
            axis_names=tuple(d.get("axis_names", ())),
            base=int(d.get("base", 0)),
        )
