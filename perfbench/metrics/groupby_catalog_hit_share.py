"""Share of the window's group-by column scans that found their run
catalog already built: the counters ``groupby.catalog_probes`` over
``groupby.catalog_probes`` plus ``groupby.catalog_builds``, the window's
bumps.  None where the program bumps neither."""
from perfbench.metrics import spans

spans.start()


def read(rec):
    probes = spans.bumps(rec, "groupby.catalog_probes".__eq__)
    builds = spans.bumps(rec, "groupby.catalog_builds".__eq__)
    if not probes and not builds:
        return None
    return 100.0 * probes / (probes + builds)
