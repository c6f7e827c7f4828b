"""The fused ``logical_reduce`` kernel's share of its bytes roofline: the
least bytes its calls in the traced window need (``arith.reduce_bytes``
of each call's flag rows) at 3.35 TB/s, over the device time of its
kernels in the profiler's trace.  Nothing to read without a launch."""
from perfbench.metrics.arith import HBM_BYTES_PER_S


def read(rec):
    t = sum(s for name, s in rec["kernel_s"].items()
            if "logical_reduce" in name)
    if rec["launches"] <= 0 or t <= 0:
        return None
    return 100.0 * rec["reduce_bytes"] / HBM_BYTES_PER_S / t
