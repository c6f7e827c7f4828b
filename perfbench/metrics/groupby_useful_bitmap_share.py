"""Share of the value bitmaps that the window's group-bys walked whose
intervals meet the statement's filter: the counters
``groupby.value_bitmaps_met`` over ``groupby.value_bitmaps``, the
window's bumps."""
from perfbench.metrics import spans

spans.start()


def read(rec):
    walked = spans.bumps(rec, "groupby.value_bitmaps".__eq__)
    if not walked:
        return None
    met = spans.bumps(rec, "groupby.value_bitmaps_met".__eq__)
    return 100.0 * met / walked
