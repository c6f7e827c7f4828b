"""Share of the index build's time spent sorting: the self seconds of the
build's ``build.sort`` spans (the column order, the external merge sort
and the permutation of rows and measures) over the self seconds of its
four steps' spans (``build.sort``, ``build.encode``, ``build.index``,
``build.shard``)."""
from perfbench.metrics import build_spans

build_spans.start()


def read(rec):
    b = build_spans.build(rec)
    if b is None:
        return None
    total = sum(b["seconds"].values())
    if total <= 0:
        return None
    return 100.0 * b["seconds"]["build.sort"] / total
