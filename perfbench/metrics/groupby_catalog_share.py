"""Share of the traced window in which some thread walked a group-by's
value bitmaps: the union of the window's ``groupby.catalog`` spans, over
every thread, over the window's wall time."""
from perfbench.metrics import spans

spans.start()


def read(rec):
    ss = spans.spans(rec, "groupby.catalog")
    if not ss or rec["window_s"] <= 0:
        return None
    return 100.0 * spans.union_seconds(ss) / rec["window_s"]
