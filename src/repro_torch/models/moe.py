"""Mixture-of-Experts: the configuration's spec only.

The MoE block (top-k routing, capacity-based sort dispatch) is not ported
yet; ``LM`` raises ``NotImplementedError`` for the moe family.
"""
from __future__ import annotations

from typing import NamedTuple


class MoESpec(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # parallel dense/shared-expert branch
