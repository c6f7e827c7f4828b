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

``process_mesh`` turns a descriptor into a ``ProcessMesh``: one process a
device, with ``torch.distributed`` groups over its axes (through
``init_device_mesh``), over which the expert-parallel MoE
(``models.moe.moe_block_ep``) runs its collectives.  Installed with
``sharding.use_mesh_rules(mesh, "opt_ep")``, it sends the model's MoE
layers down that path.  ``fake_process_mesh`` gives one over a ``fake``
group in this one process, for a trace on ``meta``: the dry-run counts the
expert-parallel MoE's collectives under it.
"""
from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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


@dataclass(frozen=True)
class ProcessMesh(Mesh):
    """A mesh whose devices each run one process of a ``torch.distributed``
    job: ``device_mesh`` is the torch ``DeviceMesh`` over the same axes,
    ranks laid row-major as the devices are."""
    device_mesh: Any = None

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> this rank's (or ``rank``'s) index along it."""
        rank = dist.get_rank() if rank is None else rank
        idx = {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            rank, idx[name] = divmod(rank, size)
        return {a: idx[a] for a in self.axis_names}

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's index on
        every axis but ``axes``: one axis's group from the device mesh,
        several axes' as the device mesh flattened over them, all axes'
        the whole job."""
        axes = tuple(axes)
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self.device_mesh[axes]._flatten().get_group()


def process_mesh(mesh: Mesh, device: str = "cuda", *,
                 init_method: Optional[str] = None,
                 rank: Optional[int] = None) -> ProcessMesh:
    """Process groups over ``mesh``, one rank a device: ``nccl`` over the
    cards for ``device="cuda"`` (the default; rank r takes card r modulo
    the host's count, and raises without CUDA), ``gloo`` over CPU
    processes for ``device="cpu"``.  Starts the job's default group from
    ``init_method`` and ``rank`` (the world size is ``mesh.size``; without
    them, from the environment as ``init_process_group`` reads it) unless
    one is up already.  Every rank calls it with the same mesh."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "for a gloo mesh")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if not dist.is_initialized():
        card = None
        if device == "cuda":    # this rank's card, bound to its group
            r = int(os.environ.get("RANK", 0)) if rank is None else rank
            card = torch.device("cuda", r % torch.cuda.device_count())
            torch.cuda.set_device(card)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=mesh.size, device_id=card)
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a {mesh.size}-device mesh in a job of "
                         f"{dist.get_world_size()} ranks")
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device, tuple(mesh.axis_sizes),
                          mesh_dim_names=tuple(mesh.axis_names))
    devices = tuple(f"cuda:{r % torch.cuda.device_count()}"
                    if device == "cuda" else "cpu"
                    for r in range(mesh.size))
    return ProcessMesh(tuple(mesh.axis_names), tuple(mesh.axis_sizes),
                       devices, dm)


@contextlib.contextmanager
def fake_process_mesh(mesh: Mesh) -> Iterator[ProcessMesh]:
    """A ``ProcessMesh`` over ``mesh`` for tracing on ``meta``: a ``fake``
    process group of ``mesh.size`` ranks, all in this process as rank 0,
    whose collectives return at once and move nothing.  It is started here
    and destroyed when the block ends; raises if a group is up already (a
    fake group never stands in for a real job's ``nccl`` or ``gloo``)."""
    if dist.is_initialized():
        raise RuntimeError("a process group is up already; a fake mesh "
                           "traces only outside a job")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        dm = init_device_mesh("cpu", tuple(mesh.axis_sizes),
                              mesh_dim_names=tuple(mesh.axis_names))
        yield ProcessMesh(tuple(mesh.axis_names), tuple(mesh.axis_sizes),
                          ("meta",) * mesh.size, dm)
    finally:
        dist.destroy_process_group()
