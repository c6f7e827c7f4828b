"""The port's row shards against the reference's, on the CPU.

``ShardedIndex`` builds, re-cuts (``reshard``), single-shard rebuilds
(``replace_shard``) and the sharded ``Dataset`` paths (``from_rows`` and
``from_chunks`` with ``shards=``, ``shard``) are held against ``repro``
bitmap for bitmap and statement for statement, under the three backends
on ``device="cpu"``.  A thread pool runs the shards' kernel path
concurrently and must give the sequential answer.  ``ShardProcessPool``
keeps the reference's fork rule: a forked worker runs the host EWAH path
on the CPU (``auto`` degrades to ``ewah``), an explicit ``kernel`` raises
``ForkSafetyError``, and no worker reads the dense operand caches it
inherits or calls a CUDA API.  Exact equality everywhere.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core import shard as r_shard
from repro.core import synth
from repro.core.executor import QueryBatch as RBatch
from repro.core.expr import col as r_col
from repro_torch.core import dataset as t_dataset
from repro_torch.core import shard as t_shard
from repro_torch.core.executor import QueryBatch as TBatch
from repro_torch.core.expr import col as t_col


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


NAMES = ["a", "b", "c", "d"]
BACKENDS = ["ewah", "kernel", "auto"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _table(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 4, r=2, rng=rng,
                                                   base_card=25))
    return table, {"sales": rng.integers(-10**9, 10**9, n)}


@pytest.fixture(scope="module")
def data():
    return _table()


def _filters(col):
    return [col("a").isin([0, 2, 4, 6, 8, 10]),
            col("a").isin([1, 3, 5, 7]) & ~(col("b") == 4),
            (col("c") == 2) | ~col("d").isin([1, 2, 3])]


def _index_statements(idx, col, **kw):
    """Every sharded statement kind straight on the index."""
    out = []
    for e in _filters(col):
        out += [idx.execute(e, **kw).set_bits().tolist(),
                idx.count(e, **kw),
                idx.group_count("c", e, **kw).tolist(),
                idx.agg("sales", e, **kw),
                {k: (v.tolist() if hasattr(v, "tolist") else v)
                 for k, v in idx.group_agg("sales", ["a", "b"], e,
                                           **kw).items()},
                idx.top_k("b", 3, e, **kw),
                idx.top_k("a", 3, e, measure="sales", **kw)]
    return out


def _words(idx):
    return [[np.asarray(bm.to_words()).tobytes() for ci in sh.columns
             for part in ci.bitmaps for bm in part] for sh in idx.shards]


def _pair(data, **kw):
    table, measures = data
    r = r_dataset.Dataset.from_rows(table, NAMES, measures=measures, **kw)
    t = t_dataset.Dataset.from_rows(table, NAMES, measures=measures,
                                    device="cpu", **kw)
    return r, t


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_from_rows_shards_matches_reference(data, sort):
    r, t = _pair(data, sort=sort, shards=3)
    assert isinstance(t.index, t_shard.ShardedIndex)
    assert t.n_shards == r.n_shards == 3
    assert t.index.offsets.tolist() == r.index.offsets.tolist()
    assert _words(t.index) == _words(r.index)
    want = _index_statements(r.index, r_col, backend="ewah")
    for backend in BACKENDS:
        assert _index_statements(t.index, t_col, backend=backend,
                                 device="cpu") == want


@pytest.mark.parametrize("n", [1, 2, 5])
def test_reshard_matches_reference(data, n):
    r, t = _pair(data, sort="lex", shards=3)
    rr, tr = r.index.reshard(n), t.index.reshard(n)
    assert tr.offsets.tolist() == rr.offsets.tolist()
    assert _words(tr) == _words(rr)
    want = _index_statements(rr, r_col, backend="ewah")
    for backend in BACKENDS:
        assert _index_statements(tr, t_col, backend=backend,
                                 device="cpu") == want


def test_build_and_replace_shard_match_reference(data):
    table, measures = data
    order = np.lexsort(table.T[::-1])
    table, measures = table[order], {"sales": measures["sales"][order]}
    cards = [int(table[:, c].max()) + 1 for c in range(4)]
    built = {}
    for name, mod in (("r", r_shard), ("t", t_shard)):
        built[name] = mod.ShardedIndex.build(table, shard_rows=1024,
                                             cards=cards, k=2,
                                             column_names=NAMES,
                                             measures=measures)
    r, t = built["r"], built["t"]
    assert _words(t) == _words(r)
    # warm every shard's result cache, then rebuild shard 1 alone
    t.count(t_col("a") == 3, backend="kernel", device="cpu")
    new_rows = table[1024:2048][::-1]
    new_m = {"sales": measures["sales"][1024:2048][::-1]}
    for name, mod in (("r", r_shard), ("t", t_shard)):
        sh = mod.ShardedIndex.build(new_rows, shard_rows=1024, cards=cards,
                                    k=2, column_names=NAMES,
                                    measures=new_m).shards[0]
        built[name].replace_shard(1, sh)
    assert t.generation == r.generation == 1
    stats = t.cache_stats()
    assert stats[1]["entries"] == 0
    assert all(s["entries"] == 1 for i, s in enumerate(stats) if i != 1)
    assert _words(t) == _words(r)
    want = _index_statements(r, r_col, backend="ewah")
    for backend in BACKENDS:
        assert _index_statements(t, t_col, backend=backend,
                                 device="cpu") == want
    short = t_shard.ShardedIndex.build(
        table[:100], shard_rows=1024, cards=cards, k=2, column_names=NAMES,
        measures={"sales": measures["sales"][:100]}).shards[0]
    with pytest.raises(ValueError, match="interior shard"):
        t.replace_shard(0, short)


def test_dataset_shard_and_from_chunks(data, tmp_path):
    table, measures = data
    r, t = _pair(data, sort="lex")
    assert t.n_shards == 1
    rs, ts = r.shard(4), t.shard(4)          # re-index the retained rows
    assert ts.device == t.device and ts.n_shards == 4
    assert _words(ts.index) == _words(rs.index)
    t.save(str(tmp_path / "t"))              # re-cut from the mapped store
    opened = t_dataset.Dataset.open(str(tmp_path / "t"), device="cpu")
    cut = opened.shard(3)
    r_cut = r_dataset.Dataset.open(str(tmp_path / "t")).shard(3)
    assert cut.table is None and cut.n_shards == 3
    assert _words(cut.index) == _words(r_cut.index)
    chunks = [table[s:s + 1700] for s in range(0, len(table), 1700)]
    rc = r_dataset.Dataset.from_chunks(iter(chunks), NAMES, shards=3)
    tc = t_dataset.Dataset.from_chunks(iter(chunks), NAMES, shards=3,
                                       device="cpu")
    assert _words(tc.index) == _words(rc.index)
    for e_t, e_r in zip(_filters(t_col), _filters(r_col)):
        for backend in BACKENDS:
            for got, want in ((ts, rs), (cut, rs), (tc, rc)):
                q = got.query(backend).where(e_t)
                p = want.query("ewah").where(e_r)
                assert q.count() == p.count()
                assert q.group_by("a", "b").count().tolist() == \
                    p.group_by("a", "b").count().tolist()
                assert q.top_k("c", 5) == p.top_k("c", 5)
        assert cut.explain(e_t) == r_cut.explain(e_r)


def test_thread_pool_kernel_path_equals_sequential(data):
    _, t = _pair(data, sort="none", shards=4)
    idx = t.index
    seq = {b: _index_statements(idx, t_col, backend=b, device="cpu")
           for b in BACKENDS}
    # fresh result caches: the pooled run recomputes every shard
    pooled = t_shard.ShardedIndex(idx.shards, column_names=NAMES)
    for sh in pooled.shards:
        sh.dense_cache.clear()
    with ThreadPoolExecutor(max_workers=4) as pool:
        for b in BACKENDS:
            assert _index_statements(pooled, t_col, backend=b, pool=pool,
                                     device="cpu") == seq[b]
        exprs = _filters(t_col)
        got = TBatch(exprs).execute(pooled, backend="kernel", pool=pool,
                                    device="cpu")
    want = RBatch(_filters(r_col)).execute(
        _pair(data, sort="none", shards=4)[0].index, backend="ewah")
    assert [g.set_bits().tolist() for g in got] == \
        [w.set_bits().tolist() for w in want]
    assert all(any(k[1] == "cpu" for k in sh.dense_cache)
               for sh in pooled.shards)


def test_guard_backend_passthrough_in_parent():
    assert t_shard._guard_backend("kernel") == "kernel"
    assert t_shard._guard_backend("auto") == "auto"
    assert not issubclass(t_shard.ForkSafetyError, RuntimeError)


_POOL_SCRIPT = r"""
import os, sys
import numpy as np
import torch
from repro_torch.core import Dataset, col, synth
from repro_torch.core.shard import (ForkSafetyError, ShardedIndex,
                                    ShardProcessPool)

PARENT = os.getpid()
called = []

def tripwire(name, real):
    def f(*a, **k):
        if os.getpid() != PARENT:
            raise AssertionError(f"forked worker called torch.cuda.{name}")
        called.append(name)
        return real(*a, **k)
    return f

for name in ("is_available", "current_stream", "synchronize", "device",
             "_lazy_init", "init"):
    setattr(torch.cuda, name, tripwire(name, getattr(torch.cuda, name)))


class Poisoned(dict):
    # a dense cache that no worker may read or fill
    def get(self, *a, **k):
        if os.getpid() != PARENT:
            raise AssertionError("forked worker read a dense cache")
        return dict.get(self, *a, **k)

    def __setitem__(self, key, value):
        if os.getpid() != PARENT:
            raise AssertionError("forked worker filled a dense cache")
        dict.__setitem__(self, key, value)


rng = np.random.default_rng(7)
table, _ = synth.factorize(synth.uniform_table(6000, 4, r=2, rng=rng,
                                               base_card=25))
sales = rng.integers(0, 1000, len(table))
names = ["a", "b", "c", "d"]
ds = Dataset.from_rows(table, names, sort="lex", shards=4,
                       measures={"sales": sales}, device="cpu")
d = sys.argv[1]
ds.save(d)
exprs = [col("a").isin([1, 2, 3]), (col("b") == 2) & ~(col("c") == 1)]
want = [(ds.index.count(e, backend="kernel", device="cpu"),
         ds.index.group_count("c", e, backend="ewah", device="cpu").tolist(),
         ds.index.agg("sales", e, backend="ewah", device="cpu"),
         ds.index.top_k("b", 3, e, backend="ewah", device="cpu"),
         ds.index.execute(e, backend="ewah", device="cpu").set_bits().tolist())
        for e in exprs]
for sh in ds.index.shards:
    sh.dense_cache = Poisoned()

for index, index_dir in ((ds.index, None),
                         (ShardedIndex.load(d), d)):
    pool = ShardProcessPool(index, workers=4, index_dir=index_dir)
    try:
        probes = pool.run_shards(("probe",), range(index.n_shards))
        assert all(p["fork_worker"] and p["pid"] != PARENT for p in probes)
        assert all(p["backend"] == "ewah" for p in probes), probes
        fresh = ShardedIndex(index.shards, column_names=names)
        got = [(fresh.count(e, backend="auto", pool=pool),
                fresh.group_count("c", e, pool=pool).tolist(),
                fresh.agg("sales", e, pool=pool),
                fresh.top_k("b", 3, e, pool=pool),
                fresh.execute(e, pool=pool).set_bits().tolist())
               for e in exprs]
        assert got == want, (got, want)
        try:
            fresh.count(exprs[1], backend="kernel", pool=pool)
        except ForkSafetyError as exc:
            assert "CUDA" in str(exc), exc
        else:
            raise AssertionError("kernel in a forked worker did not raise")
    finally:
        pool.shutdown(wait=True)
print("OK", sorted(set(called)))
"""


def test_shard_process_pool_fork_rule(tmp_path):
    # a fresh interpreter that imports only the port: forking a process
    # that other test modules have loaded JAX into is not fork-safe
    res = subprocess.run(
        [sys.executable, "-c", _POOL_SCRIPT, str(tmp_path / "store")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK"), res.stdout
