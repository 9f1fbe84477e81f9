"""Three-term roofline of one step (a port of the reference's
``roofline/analysis.py``, for one NVIDIA H100).

    compute_s    = agg_FLOPs  / (chips * peak_flops)
    memory_s     = agg_bytes  / (chips * hbm_bw)
    collective_s = agg_coll_bytes / (chips * link_bw)

The costs (an ``HloCosts``: from ``counter.count_step`` on the port, or
from ``parse_hlo_costs`` on the reference's compiled text) are PER-DEVICE
numbers; aggregate = per_device * chips, so each term reduces to
per_device_quantity / per_chip_bandwidth — reported both ways for clarity.
On one card the collective bytes, and so ``collective_s``, are 0.

Hardware model: the data sheet's dense rates of one NVIDIA H100 80GB HBM3
(SXM) at its full power limit of 700 W (``HW``); a card set below 700 W
runs slower under load, so a measured step is read beside the card's
power limit.

The fused-attention substitution (``memory_s_fused_attn``) replaces the
``flash_attn`` and ``decode_attn`` scopes' bytes by K7's analytic traffic
(``flash_io_bytes_per_device``). The reference computes it at a
16 x 16 (data x tensor) split whatever its ``chips`` (ROADMAP C-R8); the
port keeps that split on a mesh and splits nothing (1 x 1) on one card.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, Optional

from ..models.common import ArchConfig, ShapeConfig
from .hlo_parse import HloCosts, parse_hlo_costs
from .model_flops import flash_io_bytes_per_device, model_flops

__all__ = ["HW", "RooflineReport", "analyze"]


@dataclass(frozen=True)
class HW:
    """Per-card peak rates; the defaults are NVIDIA's data-sheet figures
    for the NVIDIA H100 80GB HBM3 (SXM) at 700 W, dense (no sparsity)."""

    peak_flops: float = 989e12
    """bf16 FLOP/s per card on the tensor cores: NVIDIA H100 80GB HBM3,
    700 W (the rate of ``BF16_TENSOR_FLOPS`` in ``chip_smoke.py``)."""
    hbm_bw: float = 3.35e12
    """B/s of HBM3 per card: NVIDIA H100 80GB HBM3, 700 W."""
    link_bw: float = 450e9
    """B/s of NVLink 4 per card, one direction: NVIDIA H100 80GB HBM3,
    700 W."""


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities (from the counted step)
    device_flops: float
    device_hbm_bytes: float
    device_collective_bytes: float
    collective_breakdown: Dict[str, float]
    # the three terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float
    hlo_total_flops: float            # aggregate over chips
    useful_ratio: float               # model_flops / hlo_total_flops
    # memory feasibility
    bytes_per_device: float
    fits: bool
    # context
    n_whiles: int = 0
    note: str = ""
    hbm_bytes_by_scope: Dict[str, float] = None
    # L2 substitution: memory term with the counted flash_attn scope
    # replaced by the fused kernel's analytic HBM traffic
    memory_s_fused_attn: float = 0.0
    dominant_fused_attn: str = ""

    @property
    def step_s(self) -> float:
        """Roofline-optimistic step time (terms fully overlapped)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound_fraction(self) -> Dict[str, float]:
        t = self.step_s
        if t <= 0:
            return {}
        return {
            "compute": self.compute_s / t,
            "memory": self.memory_s / t,
            "collective": self.collective_s / t,
        }

    def to_json(self) -> str:
        d = asdict(self)
        d["step_s"] = self.step_s
        return json.dumps(d)


def analyze(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh_name: str,
    chips: int,
    hlo_text: str,
    bytes_per_device: float,
    hbm_per_chip: float = 80e9,       # H100: 80 GB
    hw: HW = HW(),
    note: str = "",
    costs: Optional[HloCosts] = None,
) -> RooflineReport:
    """The report of one step from its per-device ``costs`` (or, where
    None, from ``parse_hlo_costs(hlo_text)``). The fused attention's
    traffic is split dp = tp = 1 on one chip and at the reference's
    16 x 16 on several (C-R8)."""
    if costs is None:
        costs = parse_hlo_costs(hlo_text)
    split = 1 if chips == 1 else 16
    mf = model_flops(cfg, shape)
    agg_flops = costs.flops * chips
    compute_s = costs.flops / hw.peak_flops          # == agg/(chips*peak)
    memory_s = costs.hbm_bytes / hw.hbm_bw
    collective_s = costs.total_collective_bytes / hw.link_bw
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    # fused-attention substitution (kernels/flash_attention.py): replace
    # the counted flash_attn scope bytes by the kernel's analytic traffic
    fused_io = flash_io_bytes_per_device(cfg, shape, dp=split, tp=split)
    if fused_io > 0:
        scope_attn = costs.hbm_bytes_by_scope.get(
            "flash_attn", 0.0
        ) + costs.hbm_bytes_by_scope.get("decode_attn", 0.0)
        fused_bytes = costs.hbm_bytes - scope_attn + fused_io
    else:  # kernel not applicable (train bwd unfused / no attention)
        fused_bytes = costs.hbm_bytes
    memory_s_fused = fused_bytes / hw.hbm_bw
    terms_fused = dict(terms, memory=memory_s_fused)
    dominant_fused = max(terms_fused, key=terms_fused.get)
    return RooflineReport(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        device_flops=costs.flops,
        device_hbm_bytes=costs.hbm_bytes,
        device_collective_bytes=costs.total_collective_bytes,
        collective_breakdown=dict(costs.collective_bytes),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        hlo_total_flops=agg_flops,
        useful_ratio=mf / agg_flops if agg_flops else 0.0,
        bytes_per_device=bytes_per_device,
        fits=bytes_per_device <= hbm_per_chip,
        n_whiles=costs.n_whiles,
        note=note,
        hbm_bytes_by_scope=dict(costs.hbm_bytes_by_scope),
        memory_s_fused_attn=memory_s_fused,
        dominant_fused_attn=dominant_fused,
    )
