"""PyTorch and CUDA port of the ``repro`` bitmap-index engine.

The host side — EWAH and container codecs, k-of-N encoding, the sorts,
the planner and the measure reductions — is NumPy, as in the reference.
The dense n-ary AND/OR and AND-NOT of the executor run as a hand-written
CUDA kernel on an explicit ``torch.device`` (``"cuda"`` by default;
``"cpu"`` runs the kernel's plain PyTorch version and must be asked for).
The LM substrate's training path (``configs``, ``models``, ``train``,
``distributed``, ``data``, ``launch``) trains with EWAH block-sparse
gradient compression, whose per-block norms are a second CUDA kernel.
This package never imports ``jax`` or ``repro``.
"""
from . import core, kernels
from .core import Dataset, Query, col

__all__ = ["core", "kernels", "Dataset", "Query", "col"]
