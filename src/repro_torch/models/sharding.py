"""The logical-axis sharding rules table of the reference's
``models/sharding.py``: each logical axis name of a parameter or an
activation dim mapped to the mesh axes it is split over (None: kept
whole). ``configs.profiles.optimized_opt_rules`` derives the optimized
profile's rules from it.

Only the table is ported. Applying it needs a mesh of several cards:
``sharding_context``, ``resolve_spec``, ``make_sharding`` and
``shard_hint`` are ROADMAP A11 item 3.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

__all__ = ["DEFAULT_RULES", "Rules"]

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# Default production rules: DP over pod+data, TP/EP over model.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    # the MoE dispatch buffer (E, C, D): E over model (expert parallel), C
    # over the data axes
    "expert_capacity": ("pod", "data"),
    "vocab": "model",
    "layers": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv_width": None,
    "kv_seq": None,
    "enc_seq": None,
    "vision_seq": None,
}
