"""The hand-written kernels' launches, reported to the cost counters that
are counting.

A launch goes through ``ctypes``, which the torch dispatcher does not see,
so a counter of aten ops (``launch/op_analysis.OpCounter``) would miss it.
Each wrapper calls ``launched`` once a launch is enqueued; an active counter
costs it as one op named after the kernel, its operand and result bytes
and no FLOPs, as the reference's HLO parser costs a custom call.  The
report changes nothing that the wrapper launches.
"""
from __future__ import annotations

from typing import Iterable

import torch

# the counters that are counting, innermost last (OpCounter enters and
# leaves this list)
counters: list = []


def launched(name: str, operands: Iterable[torch.Tensor],
             results: Iterable[torch.Tensor]) -> None:
    for counter in list(counters):
        counter.kernel(name, list(operands), list(results))
