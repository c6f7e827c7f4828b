"""The port's grouped aggregates (``Executor.run_group_agg``) against the
reference's and a NumPy group-by, on the CPU.

Each grouping column's run catalog is built once per index and probed by
the filter's intervals; its answers must equal the reference's walk over
every value bitmap, exactly, for unsorted and sorted tables, k = 1 and 2,
one and two grouping columns, shards of several partitions, a live
index's pinned tombstone filters, and filters from none at all to one
row.  The counters say when a catalog was built and when it was probed,
and ``ColumnIndex.invalidate_sizes`` drops it.
"""
import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core import synth
from repro.core.executor import execute_group_agg as r_group_agg
from repro.core.expr import col as r_col
from repro_torch.core import dataset as t_dataset
from repro_torch.core import measures as t_ms
from repro_torch.core.executor import execute_group_agg
from repro_torch.core.expr import col as t_col
from repro_torch.kernels import _trace


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


NAMES = ["a", "b", "c", "d"]
COLS = [["b"], ["a", "d"]]
# (sort, k, shards, partition_rows)
LAYOUTS = [("none", 1, 2, None), ("lex", 1, 2, None), ("none", 2, 2, None),
           ("lex", 2, 0, None), ("none", 1, 2, 512)]


def _table(n=3000, seed=21):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 4, r=2, rng=rng,
                                                   base_card=25))
    return table, rng.integers(-10**9, 10**9, n)


TABLE, SALES = _table()
CARDS = [int(TABLE[:, c].max()) + 1 for c in range(4)]


def _one_row():
    """A row whose four values no other row shares."""
    _, first, counts = np.unique(TABLE, axis=0, return_index=True,
                                 return_counts=True)
    return TABLE[first[np.flatnonzero(counts == 1)[0]]]


ONE = _one_row()
# name -> (expression over a column constructor, NumPy row mask)
FILTERS = {
    "none": (None, lambda x: np.ones(len(x), dtype=bool)),
    "all_false": (lambda c: c("a") == CARDS[0],
                  lambda x: np.zeros(len(x), dtype=bool)),
    "empty": (lambda c: (c("a") == 0) & (c("a") == 1),
              lambda x: np.zeros(len(x), dtype=bool)),
    "one_row": (lambda c: ((c("a") == int(ONE[0])) & (c("b") == int(ONE[1]))
                           & (c("c") == int(ONE[2]))
                           & (c("d") == int(ONE[3]))),
                lambda x: (x == ONE).all(axis=1)),
    "narrow": (lambda c: (c("a") == 3) & c("b").isin([1, 2]),
               lambda x: (x[:, 0] == 3) & np.isin(x[:, 1], [1, 2])),
    "most": (lambda c: ~(c("c") == 2), lambda x: x[:, 2] != 2),
}

_BUILT = {}


def _pair(layout):
    """The reference's and the port's dataset of one layout, built once."""
    if layout not in _BUILT:
        sort, k, shards, part = layout
        kw = dict(sort=sort, k=k, shards=shards, partition_rows=part,
                  measures={"sales": SALES})
        _BUILT[layout] = (
            r_dataset.Dataset.from_rows(TABLE, NAMES, **kw),
            t_dataset.Dataset.from_rows(TABLE, NAMES, device="cpu", **kw))
    return _BUILT[layout]


def _plain(agg):
    return {k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in agg.items()}


def _numpy_group_agg(rows, sales, cols, mask):
    """Counts, sums, mins and maxs of the cells that hold a row."""
    cs = [NAMES.index(c) for c in cols]
    cell = rows[mask, cs[0]]
    for c in cs[1:]:
        cell = cell * CARDS[c] + rows[mask, c]
    size = int(np.prod([CARDS[c] for c in cs]))
    v = sales[mask]
    counts = np.bincount(cell, minlength=size)
    sums = np.zeros(size, dtype=np.int64)
    np.add.at(sums, cell, v)
    mins = np.full(size, np.iinfo(np.int64).max)
    maxs = np.full(size, np.iinfo(np.int64).min)
    np.minimum.at(mins, cell, v)
    np.maximum.at(maxs, cell, v)
    nz = counts > 0
    return counts, sums[nz], mins[nz], maxs[nz]


def _check(got, rows, sales, cols, mask):
    counts, sums, mins, maxs = _numpy_group_agg(rows, sales, cols, mask)
    assert got["counts"].tolist() == counts.tolist()
    nz = counts > 0
    assert got["sums"][nz].tolist() == sums.tolist()
    assert got["mins"][nz].tolist() == mins.tolist()
    assert got["maxs"][nz].tolist() == maxs.tolist()


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("cols", COLS, ids=["by1", "by2"])
@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["none-k1", "lex-k1", "none-k2", "lex-k2-mono",
                              "none-k1-parts"])
def test_group_agg_matches_reference_and_numpy(layout, cols, filt):
    r, t = _pair(layout)
    if layout[3] is not None:
        assert all(sh.n_partitions > 1 for sh in t.index.shards)
    make, mask = FILTERS[filt]
    e_r = None if make is None else make(r_col)
    e_t = None if make is None else make(t_col)
    want = _plain(r_group_agg(r.index, "sales", cols, e_r, backend="ewah"))
    for backend in ("ewah", "kernel", "auto"):
        got = execute_group_agg(t.index, "sales", cols, e_t,
                                backend=backend, device="cpu")
        assert _plain(got) == want, backend
        _check(got, TABLE, SALES, cols, mask(TABLE))


@pytest.mark.parametrize("filt", ["none", "narrow", "most"])
@pytest.mark.parametrize("cols", COLS, ids=["by1", "by2"])
def test_live_group_agg_pinned_filters(cols, filt):
    """Tombstones pin the base shards' and the delta's filters
    (``PPinned``); the delta's catalog is its own index's."""
    kw = dict(sort="none", shards=2, measures={"sales": SALES[:2400]})
    t = t_dataset.Dataset.from_rows(TABLE[:2400], NAMES, device="cpu", **kw)
    r = r_dataset.Dataset.from_rows(TABLE[:2400], NAMES, **kw)
    for ds in (t, r):
        ds._ensure_live().append(TABLE[2400:],
                                 measures={"sales": SALES[2400:]})
    assert t.delete(t_col("d") == 4) == r.delete(r_col("d") == 4)
    make, mask = FILTERS[filt]
    e_r = None if make is None else make(r_col)
    e_t = None if make is None else make(t_col)
    want = _plain(r_group_agg(r.index, "sales", cols, e_r, backend="ewah"))
    for _ in range(2):      # built, then probed
        got = execute_group_agg(t.index, "sales", cols, e_t,
                                backend="ewah", device="cpu")
        assert _plain(got) == want
        _check(got, TABLE, SALES, cols, mask(TABLE) & (TABLE[:, 3] != 4))


def _delta(before, name):
    return _trace.counter_values().get(name, 0) - before.get(name, 0)


def test_second_statement_probes_the_built_catalog():
    t = t_dataset.Dataset.from_rows(TABLE, NAMES, sort="none", device="cpu",
                                    measures={"sales": SALES})
    idx = t.index
    before = _trace.counter_values()
    execute_group_agg(idx, "sales", ["a", "d"], t_col("c") == 2,
                      device="cpu")
    assert _delta(before, "groupby.catalog_builds") == 2
    assert _delta(before, "groupby.catalog_probes") == 0
    mid = _trace.counter_values()
    got = execute_group_agg(idx, "sales", ["a"], ~(t_col("c") == 2),
                            device="cpu")
    assert _delta(mid, "groupby.catalog_builds") == 0
    assert _delta(mid, "groupby.catalog_probes") == 1
    _check(got, TABLE, SALES, ["a"], TABLE[:, 2] != 2)
    # the walked and met value bitmaps count as the walk counted them
    assert _delta(mid, "groupby.value_bitmaps") == CARDS[0]
    assert _delta(mid, "groupby.value_bitmaps_met") == len(
        np.unique(TABLE[TABLE[:, 2] != 2, 0]))


def test_invalidate_sizes_drops_the_catalog():
    t = t_dataset.Dataset.from_rows(TABLE, NAMES, sort="lex", device="cpu",
                                    measures={"sales": SALES})
    idx = t.index
    e = t_col("b").isin([0, 5, 7])
    first = _plain(execute_group_agg(idx, "sales", ["c"], e, device="cpu"))
    before = _trace.counter_values()
    execute_group_agg(idx, "sales", ["c"], e, device="cpu")
    assert _delta(before, "groupby.catalog_builds") == 0
    ci = idx.columns[NAMES.index("c")]

    def no_build():
        raise AssertionError("a built catalog was built again")
    (starts, ranks), built = ci.run_catalog(no_build)
    assert not built and len(starts) == len(ranks) and starts[0] == 0
    ci.invalidate_sizes()
    mid = _trace.counter_values()
    again = _plain(execute_group_agg(idx, "sales", ["c"], e, device="cpu"))
    assert _delta(mid, "groupby.catalog_builds") == 1
    assert _delta(mid, "groupby.catalog_probes") == 0
    assert again == first


def test_probe_clips_runs_to_the_filter():
    # ranks by row: 0 0 1 1 1 2 0 0 | 2 2 (10 rows, runs at 0, 2, 5, 6, 8)
    ranks = np.array([0, 0, 1, 1, 1, 2, 0, 0, 2, 2])
    iv = [(np.flatnonzero(ranks == r), None) for r in range(3)]
    iv = [(s[np.r_[True, np.diff(s) > 1]], None) for s, _ in iv]
    starts, rk = t_ms.run_catalog(iv, 10)
    assert starts.tolist() == [0, 2, 5, 6, 8] and rk.tolist() == [0, 1, 2,
                                                                  0, 2]
    assert starts.dtype == np.int32 and rk.dtype == np.uint8
    # filter rows 1, 4-6 and 9: runs 0, 1, 2, 0 (clipped), 2
    S, E, R = t_ms.probe_catalog(starts, rk, 10, np.array([1, 4, 9]),
                                 np.array([2, 7, 10]))
    assert S.tolist() == [0, 1, 2, 3, 4]
    assert E.tolist() == [1, 2, 3, 4, 5]
    assert R.tolist() == [0, 1, 2, 0, 2]
    # the whole rows: the whole catalog
    S, E, R = t_ms.probe_catalog(starts, rk, 10, np.array([0]),
                                 np.array([10]))
    assert S.tolist() == [0, 2, 5, 6, 8] and E.tolist() == [2, 5, 6, 8, 10]
