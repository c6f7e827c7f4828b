"""The repro_torch slice end to end vs the reference package.

The same fact table, made with NumPy from a seed, is built and queried by
``repro`` and by ``repro_torch`` (``device="cpu"``: the kernel's plain
version) under each backend, on a sorted table and on an unsorted one
(``sort="none"``, hybrid containers).  Every statement must agree exactly:
integers equal, floats equal in bits with NaN in the same places, and the
``explain()`` text identical.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import cost_model as r_cm
from repro.core import dataset as r_dataset
from repro.core import synth
from repro.core.expr import col as r_col
from repro_torch.core import cost_model as t_cm
from repro_torch.core import dataset as t_dataset
from repro_torch.core import index as t_index
from repro_torch.core.expr import col as t_col
from repro_torch.kernels import ops as t_ops


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


@pytest.fixture(autouse=True)
def default_cost_models():
    """Both packages plan with the static default crossover, whatever a
    calibration file on this host says."""
    old_r, old_t = r_cm._default, t_cm._default
    r_cm.set_default(r_cm.CostModel())
    t_cm.set_default(t_cm.CostModel())
    yield
    r_cm.set_default(old_r)
    t_cm.set_default(old_t)


def _table(n=1 << 13, seed=0, base_card=100):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 4, r=2, rng=rng,
                                                   base_card=base_card))
    measures = {"sales": rng.integers(-10**15, 10**15, n),
                "price": rng.standard_normal(n) * 100.0}
    return table, measures


@pytest.fixture(scope="module")
def data():
    return _table()


def _filters(col, table):
    widest = int(np.argmax(table.max(axis=0)))
    narrow = int(np.argmin(table.max(axis=0)))
    wn, nn = NAMES[widest], NAMES[narrow]
    vals = sorted({int(v) for v in table[:40, widest]})
    return {
        "in": col(wn).isin(vals),
        "andnot": col(wn).isin(vals) & ~(col(nn) == int(table[3, narrow])),
        "mixed": (col(nn) == int(table[0, narrow]))
        | ~col(NAMES[2]).isin([int(table[1, 2]), int(table[9, 2])]),
        "range_andnot": col(nn).between(0, 40)
        & ~col(wn).isin(vals[:5]),
    }


def _run_statements(ds, col, table, backend):
    out = {}
    for fname, e in _filters(col, table).items():
        q = ds.query(backend=backend).where(e)
        out[fname, "count"] = q.count()
        out[fname, "explain"] = q.explain()
        out[fname, "group"] = q.group_by("c").count()
        out[fname, "top_k"] = q.top_k("b", 5)
        out[fname, "top_k_sales"] = q.top_k("d", 4, "sales")
        for m in ("sales", "price"):
            for op in ("sum", "avg", "min", "max"):
                out[fname, op, m] = getattr(q, op)(m)
        out[fname, "g2_sum"] = q.group_by("a", "b").sum("sales")
        out[fname, "g2_avg"] = q.group_by("a", "c").avg("price")
        out[fname, "g_min"] = q.group_by("b").min("price")
        out[fname, "rows100"] = q.rows(limit=100)
        out[fname, "rows"] = q.rows()
    q = ds.query(backend=backend)
    out["all", "count"] = q.count()
    out["all", "group"] = q.group_by("a").count()
    out["all", "sum"] = q.sum("sales")
    return out


def _same(x, y):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype.kind == "f":
            return np.array_equal(x.view(np.int64), y.view(np.int64))
        return np.array_equal(x, y)
    if isinstance(x, (list, tuple)):
        return type(x) is type(y) and len(x) == len(y) and \
            all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, float) or isinstance(y, float):
        return type(x) is type(y) and \
            np.float64(x).view(np.int64) == np.float64(y).view(np.int64)
    return type(x) is type(y) and x == y


def _build_both(table, measures, sort):
    r = r_dataset.Dataset.from_rows(table, NAMES, sort=sort,
                                    measures=measures)
    t = t_dataset.Dataset.from_rows(table, NAMES, sort=sort,
                                    measures=measures, device="cpu")
    return r, t


@pytest.fixture(scope="module")
def built(data):
    table, measures = data
    return {s: _build_both(table, measures, s) for s in ("lex", "none")}


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_build_matches_reference(built, sort):
    r, t = built[sort]
    assert t.size_words == r.size_words
    assert t.sort_order == r.sort_order
    assert t._container == r._container
    assert np.array_equal(t.table, r.table)
    for c in range(len(NAMES)):
        for p_part, r_part in zip(t.index.columns[c].bitmaps,
                                  r.index.columns[c].bitmaps):
            for bp, br in zip(p_part, r_part):
                assert np.array_equal(bp.words, br.words)
                assert (bp._cont is None) == (br._cont is None)
                if bp._cont is not None:
                    assert np.array_equal(bp._cont.serialize(),
                                          br._cont.serialize())
    e_t = t_col("a").isin([1, 2, 3]) & ~(t_col("b") == 4)
    e_r = r_col("a").isin([1, 2, 3]) & ~(r_col("b") == 4)
    assert t.explain(e_t) == r.explain(e_r)


def _exprs(col):
    from repro_torch.core import expr as t_expr
    from repro.core import expr as r_expr
    E = t_expr if col is t_col else r_expr
    return [
        col("a") == 3,
        col("b").isin([1, 5, 9, 70]),
        col("c").between(10, 90),
        ~(col("d") == 2),
        (col("a") == 1) | ((col("b") == 2) & ~col("c").isin([3, 4])),
        col("a").isin(list(range(50))) & ~col("d").between(0, 300),
        E.And((col("a") == 1, E.Const(True))),
        E.Or((col("b") == 9, E.Const(False))),
        ~(~(col("c") == 7) | (col("d") == 11)),
    ]


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_plans_and_explain_text_match(built, sort):
    from repro.core.planner import Planner as RPlanner, explain as r_explain
    from repro_torch.core.planner import Planner as TPlanner, \
        explain as t_explain
    r, t = built[sort]
    for et, er in zip(_exprs(t_col), _exprs(r_col)):
        assert t_explain(TPlanner(t.index).plan(et)) == \
            r_explain(RPlanner(r.index).plan(er))
        assert t.explain(et) == r.explain(er)
        assert t.query().where(et).explain() == \
            r.query().where(er).explain()
        assert t_explain(TPlanner(t.index).plan_group_agg(
            "sales", ["a", "b"], et)) == r_explain(
                RPlanner(r.index).plan_group_agg("sales", ["a", "b"], er))


class _Spy:
    """Counts the port's dense kernel path (``logical_reduce`` and
    ``diff_reduce`` calls)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in ("logical_reduce", "diff_reduce"):
            real = getattr(t_ops, name)

            def wrapped(*args, _real=real, **kwargs):
                self.calls += 1
                return _real(*args, **kwargs)
            monkeypatch.setattr(t_ops, name, wrapped)


@pytest.mark.parametrize("sort", ["lex", "none"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_statements_match_reference(built, data, sort, backend,
                                    monkeypatch):
    table = data[0]
    r, t = built[sort]
    spy = _Spy(monkeypatch)
    got = _run_statements(t, t_col, t.table, backend)
    want = _run_statements(r, r_col, r.table, backend)
    assert got.keys() == want.keys()
    bad = [k for k in want if not _same(got[k], want[k])]
    assert not bad, bad[:5]
    # and the answers are right, not merely equal: a NumPy mask oracle
    tt = t.table
    vals = sorted({int(v) for v in table[:40, 0]})
    assert t.query(backend=backend).where(t_col("a").isin(vals)).count() \
        == int(np.isin(tt[:, 0], vals).sum())
    if backend == "kernel":
        assert spy.calls > 0
    if backend == "ewah":
        assert spy.calls == 0
    if backend == "auto" and sort == "none":
        # dense unsorted AND-NOT operands cross the crossover
        assert spy.calls > 0


def test_dense_operands_are_cached_once_per_bitmap(data):
    table, measures = data
    t = t_dataset.Dataset.from_rows(table, NAMES, sort="none",
                                    measures=measures, device="cpu")
    e = t_col("a").isin(list(range(12))) & ~(t_col("b") == 3)
    assert t.index.dense_cache == {}
    t.query(backend="kernel").where(e).count()
    keys = set(t.index.dense_cache)
    assert len(keys) == 13 and all(k[0] == "dense" and k[1] == "cpu"
                                   for k in keys)
    words, flags = next(iter(t.index.dense_cache.values()))
    ids = {id(v[0]) for v in t.index.dense_cache.values()}
    t.query(backend="kernel").where(e).group_by("c").count()
    assert set(t.index.dense_cache) == keys
    assert {id(v[0]) for v in t.index.dense_cache.values()} == ids


def _dump_reference_index(index):
    """A reference ``BitmapIndex`` as plain NumPy arrays and scalars: the
    carry-over format of ``repro_torch.core.index.index_from_numpy``."""
    return {
        "n_rows": index.n_rows,
        "partition_bounds": np.asarray(index.partition_bounds),
        "column_names": index.column_names,
        "columns": [{
            "card": ci.encoder.card, "k": ci.encoder.k,
            "allocation": ci.encoder.allocation,
            "remap": ci.encoder.remap,
            "bitmaps": [[(np.asarray(bm.words), bm.n_bits) for bm in part]
                        for part in ci.bitmaps],
        } for ci in index.columns],
        "measures": {k: np.asarray(v) for k, v in index.measures.items()}
        if index.measures else None,
    }


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_index_from_numpy_round_trip(sort):
    # narrower columns than ``data``: k=2 group-bys AND two bitmaps per value
    table, measures = _table(n=1 << 12, seed=1, base_card=12)
    r = r_dataset.Dataset.from_rows(table, NAMES, sort=sort, k=2,
                                    measures=measures, partition_rows=1024,
                                    remap=True)
    state = _dump_reference_index(r.index)
    idx = t_index.index_from_numpy(state)
    t = t_dataset.Dataset(idx, NAMES, device="cpu")
    assert idx.n_partitions == r.index.n_partitions == 4
    # the reference's answers do not depend on its backend (see
    # test_statements_match_reference), and its interpreted kernel would
    # dominate the run here: one k=2 AND per group value
    want = _run_statements(r, r_col, r.table, "ewah")
    for backend in BACKENDS:
        got = _run_statements(t, t_col, r.table, backend)
        bad = [k for k in want if not _same(got[k], want[k])]
        assert not bad, (backend, bad[:5])


def test_index_from_numpy_rejects_inconsistent_state(data):
    table, measures = data
    r = r_dataset.Dataset.from_rows(table[:4096], NAMES, sort="lex",
                                    partition_rows=2048)
    state = _dump_reference_index(r.index)
    state["columns"][0]["bitmaps"][1] = state["columns"][0]["bitmaps"][1][1:]
    with pytest.raises(ValueError, match="bitmaps"):
        t_index.index_from_numpy(state)
    state = _dump_reference_index(r.index)
    state["partition_bounds"] = np.array([0, 4096])
    with pytest.raises(ValueError, match="partitions"):
        t_index.index_from_numpy(state)


def test_from_chunks_and_spill_builds_match_reference(data, tmp_path):
    table, _ = data
    chunks = [table[s:s + 3000] for s in range(0, len(table), 3000)]
    r = r_dataset.Dataset.from_chunks(iter(chunks), NAMES, sort="lex")
    t = t_dataset.Dataset.from_chunks(iter(chunks), NAMES, sort="lex",
                                      device="cpu")
    assert t.size_words == r.size_words
    rs = r_dataset.Dataset.from_rows(table, NAMES, sort="lex",
                                     spill_dir=str(tmp_path / "r"),
                                     chunk_rows=1024)
    ts = t_dataset.Dataset.from_rows(table, NAMES, sort="lex",
                                     spill_dir=str(tmp_path / "t"),
                                     chunk_rows=1024, device="cpu")
    assert ts.size_words == rs.size_words
    e_t, e_r = t_col("b") == 7, r_col("b") == 7
    assert ts.query().where(e_t).group_by("a").count().tolist() == \
        rs.query().where(e_r).group_by("a").count().tolist()


def _live_statements(ds, col, backend):
    out = []
    for e in (col("a").isin([1, 2, 3, 5, 8]),
              col("b").isin([0, 1, 2, 3]) & ~(col("c") == 1)):
        q = ds.query(backend).where(e)
        out += [q.count(), q.group_by("c").count().tolist(),
                q.group_by("a", "b").count().tolist(), q.top_k("d", 4),
                q.rows().tolist()]
    return out


def _mutated(col, ds, rows):
    ds.append(rows)
    return ds, ds.delete(col("d").isin([0, 2]))


def _served(ds):
    """Statements of every kind through ``ds.serve()`` (the port's on the
    dataset's device): the decoded answers, and the stats without the
    port's own counter blocks, which the reference lacks
    (``tests/test_torch_trace.py`` reads them)."""
    svc = ds.serve(max_rows=50)
    where = {"op": "and", "args": [
        {"op": "in", "col": "a", "values": [1, 2, 3, 5]},
        {"op": "not", "arg": {"op": "eq", "col": "c", "value": 1}}]}
    try:
        return [svc.query(where), svc.query_batch([where, where]),
                svc.statement({"select": {"count": True}, "where": where}),
                svc.statement({"select": {"group_count": "b"},
                               "where": where}),
                svc.statement({"select": {"top_k": {"col": "d", "k": 3}}}),
                svc.sql("SELECT count(*) FROM t WHERE b BETWEEN 1 AND 4 "
                        "GROUP BY a, d"),
                {k: v for k, v in svc.stats().items()
                 if k not in ("counters", "statements")}]
    finally:
        svc.close()


# the calls that later slices of the port made work: each on a dataset of
# either package, returning (dataset to query, value to compare)
LATER_SLICE_CALLS = {
    "save": lambda D, col, ds, d: (ds, sorted(
        (f, open(os.path.join(d, f), "rb").read())
        for f in os.listdir(ds.save(d).dir_path))),
    "shard": lambda D, col, ds, d: (ds.shard(2), ds.shard(2).n_shards),
    "append": lambda D, col, ds, d: (ds, ds.append(ds.table[:700][::-1])),
    "delete": lambda D, col, ds, d: _mutated(col, ds, ds.table[:300]),
    "compact": lambda D, col, ds, d: (ds, (_mutated(col, ds, ds.table[:500]),
                                           ds.compact())[1]),
    "optimize": lambda D, col, ds, d: (ds, ds.optimize()),
    "open": lambda D, col, ds, d: (D.open(ds.save(d).dir_path,
                                          **({"device": "cpu"} if D is
                                             t_dataset.Dataset else {})),
                                   None),
    "from_rows_shards": lambda D, col, ds, d: (D.from_rows(
        ds.table, NAMES, sort="none", shards=3,
        **({"device": "cpu"} if D is t_dataset.Dataset else {})), None),
    "serve": lambda D, col, ds, d: (ds, _served(ds)),
}


@pytest.mark.parametrize("call", list(LATER_SLICE_CALLS))
def test_later_slices_work_like_reference(data, tmp_path, call):
    table, _ = data
    table = table[:4096]
    r = r_dataset.Dataset.from_rows(table, NAMES, sort="lex")
    t = t_dataset.Dataset.from_rows(table, NAMES, sort="lex", device="cpu")
    fn = LATER_SLICE_CALLS[call]
    r_ds, r_val = fn(r_dataset.Dataset, r_col, r, str(tmp_path / "r"))
    t_ds, t_val = fn(t_dataset.Dataset, t_col, t, str(tmp_path / "t"))
    assert t_val == r_val
    assert t_ds.device == t.device
    assert t_ds.n_rows == r_ds.n_rows and t_ds.n_shards == r_ds.n_shards
    want = _live_statements(r_ds, r_col, "ewah")
    for backend in BACKENDS:
        assert _live_statements(t_ds, t_col, backend) == want


def test_default_device_is_cuda_and_never_falls_back(data):
    import torch
    table, _ = data
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_dataset.Dataset.from_rows(table, NAMES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_dataset.Dataset.from_chunks([table], NAMES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cm.calibrate(n_words=1024, densities=(0.5,), repeats=1)
    from repro_torch.core.executor import Executor
    ds = t_dataset.Dataset.from_rows(table[:512], NAMES, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor(ds.index, backend="ewah")


def test_calibrate_on_cpu_when_asked(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_COST_MODEL", str(tmp_path / "cm.json"))
    assert t_cm.default_path() == tmp_path / "cm.json"
    monkeypatch.delenv("REPRO_TORCH_COST_MODEL")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert t_cm.default_path() == tmp_path / "repro_torch" / "cost_model.json"
    assert r_cm.default_path() != t_cm.default_path()
    cm = t_cm.calibrate(n_words=2048, n_operands=4, densities=(0.1, 0.9),
                        repeats=1, device="cpu")
    assert cm.calibrated and cm.source == "calibrated-cpu"
    assert [s["density"] for s in cm.samples] == [0.1, 0.9]
    cm.save()
    assert t_cm.CostModel.load().dense_threshold == cm.dense_threshold


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.train\n"
        "import repro_torch.distributed, repro_torch.data\n"
        "import repro_torch.launch.train, repro_torch.train.loop\n"
        "import repro_torch.distributed.checkpoint\n"
        "import repro_torch.distributed.grad_compression\n"
        "import repro_torch.core.store, repro_torch.core.shard\n"
        "import repro_torch.core.wal, repro_torch.core.ingest\n"
        "import repro_torch.core.lru, repro_torch.core.wah\n"
        "import repro_torch.core.query\n"
        "import repro_torch.serve.query_api, repro_torch.serve.worker_api\n"
        "import repro_torch.distributed.wire\n"
        "import repro_torch.distributed.cluster\n"
        "import repro_torch.launch.cluster\n"
        "import repro_torch.models.decode, repro_torch.serve.loop\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
