"""One statement path under the service, on the CPU.

A group count is the ``counts`` of the one-column group-by that the
column's run catalog answers: on a monolithic, a 4-shard and a live index
(appended rows and tombstones), over unsorted and sorted rows, under
filters from none to fragmented, on the host EWAH path and the plain
kernel path, it equals ``group_agg(None, [col])``, the reference's group
count and NumPy's, and a second statement on the column probes the
catalog the first built.  And the in-process ``ShardedIndex`` fan-out
returns, for every statement task kind, exactly what ``run_shard_task``
returns shard by shard — the one definition the forked ``ShardProcessPool``
and the RPC workers run too — under the shard-LRU keys the statements
have always had.
"""
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core.executor import execute_group_count as r_group_count
from repro.core.expr import col as r_col
from repro_torch.core import dataset as t_dataset
from repro_torch.core.ewah import EWAH
from repro_torch.core.executor import execute_group_agg, execute_group_count
from repro_torch.core.expr import canonical_key, col as t_col
from repro_torch.core.shard import merge_partials, run_shard_task
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
CARDS = [6, 40, 160, 12]
_RNG = np.random.default_rng(31)
TABLE = np.stack([_RNG.integers(0, c, 4000) for c in CARDS], axis=1)
SALES = _RNG.integers(-1000, 1000, 4000)
BASE = 3000     # the live index's base rows; the rest are appended
DEAD = 4        # the live index deletes the rows where d == DEAD

# name -> (expression over a column constructor, NumPy row mask)
FILTERS = {
    "none": (None, lambda x: np.ones(len(x), dtype=bool)),
    "all_false": (lambda c: c("a") == CARDS[0],
                  lambda x: np.zeros(len(x), dtype=bool)),
    "selective": (lambda c: (c("a") == 3) & c("d").isin([1, 2]),
                  lambda x: (x[:, 0] == 3) & np.isin(x[:, 3], [1, 2])),
    "fragmented": (lambda c: c("d").isin(range(0, CARDS[3], 2))
                   | (c("b") == 7),
                   lambda x: (x[:, 3] % 2 == 0) | (x[:, 1] == 7)),
}


def _dataset(mod, kind, sort, **kw):
    """A monolithic, 4-shard or live dataset of ``TABLE``; the live one
    appends the rows past ``BASE`` to a 4-shard base and deletes
    ``d == DEAD`` from both layers."""
    rows = TABLE[:BASE] if kind == "live" else TABLE
    ds = mod.Dataset.from_rows(rows, NAMES, sort=sort, cards=CARDS,
                               shards=0 if kind == "mono" else 4, **kw)
    if kind == "live":
        ds._ensure_live().append(TABLE[BASE:])
        col = r_col if mod is r_dataset else t_col
        assert ds.delete(col("d") == DEAD) == int(
            (TABLE[:, 3] == DEAD).sum())
    return ds


_REFERENCE = {}


def _reference(kind, sort):
    if (kind, sort) not in _REFERENCE:
        _REFERENCE[kind, sort] = _dataset(r_dataset, kind, sort)
    return _REFERENCE[kind, sort]


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


@pytest.mark.parametrize("backend", ["ewah", "kernel"])
@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("sort", ["none", "lex"])
@pytest.mark.parametrize("kind", ["mono", "4shards", "live"])
def test_group_count_is_the_catalog_group_by(kind, sort, filt, backend):
    r = _reference(kind, sort)
    t = _dataset(t_dataset, kind, sort, device="cpu")  # no catalog built
    make, mask = FILTERS[filt]
    e_r = None if make is None else make(r_col)
    e_t = None if make is None else make(t_col)
    keep = mask(TABLE)
    if kind == "live":
        keep &= TABLE[:, 3] != DEAD
    for c in ("b", "c"):
        before = _trace.counter_values()
        got = execute_group_count(t.index, c, e_t, backend=backend,
                                  device="cpu")
        mid = _trace.counter_values()
        again = execute_group_agg(t.index, None, [c], e_t, backend=backend,
                                  device="cpu")["counts"]
        after = _trace.counter_values()
        want = np.bincount(TABLE[keep, NAMES.index(c)],
                           minlength=CARDS[NAMES.index(c)])
        assert got.dtype == np.int64
        assert got.tolist() == want.tolist()
        assert again.tolist() == want.tolist()
        assert np.asarray(r_group_count(r.index, c, e_r, backend="ewah")
                          ).tolist() == want.tolist()
        # every layer the filter meets builds the column's catalog once;
        # the second statement probes what the first built
        met = (_delta(before, mid, "groupby.catalog_builds")
               + _delta(before, mid, "groupby.catalog_probes"))
        assert _delta(before, mid, "groupby.catalog_probes") == 0
        assert _delta(mid, after, "groupby.catalog_builds") == 0
        assert _delta(mid, after, "groupby.catalog_probes") == met
        assert (met > 0) == (filt != "all_false")


def _plain(x):
    """``x`` with every type and value spelled out, for exact equality."""
    if isinstance(x, EWAH):
        return ("EWAH", x.n_bits, x.to_words().tolist())
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    return (type(x).__name__, x)


KINDS = ["expr", "count", "gcount", "agg", "gagg", "gtop", "gvals"]


def _tasks(e, backend):
    """kind -> (task, the shard-LRU key its statement has always had, or
    ``None`` for none)."""
    ck = canonical_key(e)
    return {
        "expr": (("expr", e), ("expr", backend, True, ck)),
        "count": (("count", e), ("count", backend, True, ck)),
        "gcount": (("gcount", 2, e), ("gcount", 2, backend, True, ck)),
        "agg": (("agg", "sales", e), ("agg", "sales", backend, True, ck)),
        "gagg": (("gagg", "sales", (1, 3), e),
                 ("gagg", "sales", (1, 3), backend, True, ck)),
        "gtop": (("gtop", 2, e, 5, "sales"),
                 ("gtop", 2, "sales", 5, backend, True, ck)),
        "gvals": (("gvals", 2, e, (1, 5, 9), "sales"), None),
    }


_FAN_OUT = None


def _sharded():
    global _FAN_OUT
    if _FAN_OUT is None:
        _FAN_OUT = t_dataset.Dataset.from_rows(
            TABLE, NAMES, sort="lex", cards=CARDS, shards=4,
            measures={"sales": SALES}, device="cpu")
    return _FAN_OUT.index


@pytest.mark.parametrize("pool, backend", [(None, "ewah"),
                                           ("threads", "kernel")],
                         ids=["in-turn-ewah", "threads-kernel"])
@pytest.mark.parametrize("kind", KINDS)
def test_fan_out_is_run_shard_task_shard_by_shard(kind, pool, backend):
    idx = _sharded()
    assert idx.n_shards == 4
    e = FILTERS["fragmented"][0](t_col)
    task, key = _tasks(e, backend)[kind]
    want = [run_shard_task(sh, task, backend=backend, device="cpu")
            for sh in idx.shards]
    with ThreadPoolExecutor(4) if pool else nullcontext() as p:
        got = idx._fan_out(key, task, backend, True, None, p, "cpu")
        if kind not in ("gtop", "gvals"):
            assert _plain(idx.partials(task, backend, pool=p,
                                       device="cpu")) == _plain(want)
    assert _plain(got) == _plain(want)
    if key is not None:
        assert [_plain(c.get(key)) for c in idx._result_caches] \
            == _plain(want)
    # the statement's merge is written once, for every index kind
    method = {"expr": lambda: idx.execute(e, backend, device="cpu"),
              "count": lambda: idx.count(e, backend, device="cpu"),
              "gcount": lambda: idx.group_count(2, e, backend, device="cpu"),
              "agg": lambda: idx.agg("sales", e, backend, device="cpu"),
              "gagg": lambda: idx.group_agg("sales", (1, 3), e, backend,
                                            device="cpu")}.get(kind)
    if method is not None:
        assert _plain(method()) == _plain(merge_partials(kind, want))
