"""Production meshes, as descriptors: axis names and sizes, no devices.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod : 2 pods = 512 devices, axes (pod, data, model); 'pod' is a pure
data-parallel axis (the gradient all-reduce crosses pod links once per
step) that also joins the FSDP axis group, so the 400-480B-parameter archs
fit.

The reference builds these meshes over 512 placeholder host devices of
JAX.  Torch cannot make 512 devices, and the port needs none: the sharding
rules (``distributed/sharding.py``) read a mesh's ``shape`` and
``axis_names`` only, so a production mesh here is the descriptor alone.
``make_host_mesh`` gives the same descriptor over real devices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``axis_names`` with ``axis_sizes``, and the
    real devices laid over it (row-major) where there are any."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[str, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as a JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str = "cuda") -> Mesh:
    """A (data, model) mesh over this host's cards (``device="cuda"``, the
    default; raises when there are fewer than ``data * model``), or over
    its one CPU (``device="cpu"``, a 1 x 1 mesh only)."""
    n = data * model
    if device == "cpu":
        if n != 1:
            raise ValueError(f"the CPU is one device; a {data} x {model} "
                             f"mesh needs {n}")
        return Mesh(("data", "model"), (1, 1), ("cpu",))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} CUDA devices, have {have}")
    return Mesh(("data", "model"), (data, model),
                tuple(f"cuda:{i}" for i in range(n)))
