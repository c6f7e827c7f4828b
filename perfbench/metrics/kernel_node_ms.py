"""Mean host time of one kernel-path node of the window: the
``exec.kernel_node`` spans, from the dense operands through the launch,
the copy back and ``EWAH.from_words``."""
from perfbench.metrics import spans

spans.start()


def read(rec):
    ss = spans.spans(rec, "exec.kernel_node")
    if not ss:
        return None
    return 1e3 * spans.seconds(ss) / len(ss)
