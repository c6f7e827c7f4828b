"""Mamba-2 (SSD): the configuration's spec only.

The SSD block and its decode are not ported yet; ``LM`` raises
``NotImplementedError`` for the ssm and hybrid families.
"""
from __future__ import annotations

from typing import NamedTuple


class SSMSpec(NamedTuple):
    d_inner: int
    state_dim: int          # N
    head_dim: int = 64      # P
    n_groups: int = 1       # G (B/C groups)
    d_conv: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim
