"""The port's query service and HTTP endpoint against the reference's, on
the CPU.

The same rows go into ``repro.serve.query_api`` (backend ``ewah``) and
``repro_torch.serve.query_api`` (``device="cpu"``, under ``ewah``,
``kernel`` and ``auto``); the same request sequence goes to both.  Decoded
HTTP responses must be equal (they carry no timing field), and so must the
result LRU's hit, miss and eviction counts; counts, rows, result words,
group vectors, top-k, measures and SQL answers are held exactly.  Also:
warm start, reload, the watcher, scrub, live ingest and optimize over a
store directory, ``Dataset.serve``, the device defaults, statements from
many HTTP threads on one index, and the smoke's serving phase at a tiny
size in a fresh interpreter (it forks and spawns).
"""
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.core import BitmapIndex as RIndex
from repro.core import IndexBuilder as RBuilder
from repro.core import ShardedIndex as RSharded
from repro.core import dataset as r_dataset
from repro.core import lex_sort, synth
from repro.core import query as r_query
from repro.core.expr import col as r_col
from repro.core.store import write_shard_file as r_write_shard
from repro.serve import query_api as rq
from repro_torch.core import BitmapIndex as TIndex
from repro_torch.core import IndexBuilder as TBuilder
from repro_torch.core import ShardedIndex as TSharded
from repro_torch.core import dataset as t_dataset
from repro_torch.core.expr import col as t_col
from repro_torch.core.store import write_shard_file as t_write_shard
from repro_torch.serve import query_api as tq

NAMES = ["dim0", "dim1", "dim2"]
BACKENDS = ["ewah", "kernel", "auto"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """The suite runs several workers side by side: two intra-op threads a
    test, and in the processes it starts, keep this file from starving
    other files' timing-sensitive tests of cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(n)


def _table(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 3, r=2, rng=rng))
    return table[lex_sort(table)]


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture(scope="module")
def indexes(table):
    return (RIndex.build(table, k=2, column_names=NAMES),
            TIndex.build(table, k=2, column_names=NAMES))


def _services(r_index, t_index, backend, **kw):
    return (rq.QueryService(r_index, backend="ewah", **kw),
            tq.QueryService(t_index, backend=backend, device="cpu", **kw))


def _stats(svc):
    """``svc.stats()`` without the port's own counter blocks, which the
    reference's ``/stats`` lacks (``tests/test_torch_trace.py`` reads
    them)."""
    return _shared_stats(svc.stats())


def _shared_stats(stats):
    out = dict(stats)
    if out.pop("counters", None) is not None:
        assert isinstance(out.pop("statements"), dict)
    return out


class Served:
    """A reference and a port service, each mounted over HTTP; every
    request goes to both and their decoded answers must be equal."""

    def __init__(self, r_svc, t_svc, paths=None, **kw):
        # ``paths``: (reference path, port path) — a store directory the
        # two answers name, each its own
        self.paths = paths
        self.svcs = (r_svc, t_svc)
        self.srvs, self.bases = [], []
        for mod, svc in ((rq, r_svc), (tq, t_svc)):
            srv, port = mod.serve_in_thread(svc, **kw)
            self.srvs.append(srv)
            self.bases.append(f"http://127.0.0.1:{port}")

    def call(self, path, body=None, raw=None):
        """(status, decoded body) of the port, equal to the reference's."""
        outs = []
        for base in self.bases:
            data = raw if raw is not None else (
                None if body is None else json.dumps(body).encode())
            req = urllib.request.Request(
                base + path, data=data,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as resp:
                    outs.append((resp.status, json.loads(resp.read())))
            except urllib.error.HTTPError as err:
                outs.append((err.code, json.loads(err.read())))
        if self.paths is not None:
            outs[0] = tuple(json.loads(json.dumps(outs[0]).replace(
                *self.paths)))
        if path == "/stats":
            outs = [(status, _shared_stats(out)) for status, out in outs]
        assert outs[1] == outs[0], (path, body)
        return outs[1]

    def post(self, path, body):
        status, out = self.call(path, body)
        assert status == 200, out
        return out

    def close(self):
        for srv in self.srvs:
            srv.shutdown()
            srv.server_close()
        for svc in self.svcs:
            svc.close()


def _both(r_svc, t_svc, fn):
    """``fn`` on both services; the port's answer, equal to the
    reference's."""
    want, got = fn(r_svc), fn(t_svc)
    assert got == want
    return got


# -- wire format and parsers ------------------------------------------------

def test_wire_format_matches_reference():
    for col, mod in ((r_col, rq), (t_col, tq)):
        e = ((col("region") == 3) & ~col("day").between(10, 20)) \
            | col(2).isin([1, 2, 2])
        assert mod.parse_expr(mod.expr_to_json(e)) == e
        r = col(0) >= 7
        assert mod.parse_expr(mod.expr_to_json(r)) == r
    e_r = (r_col("a") == 1) & ~r_col(1).isin([3, 4])
    e_t = (t_col("a") == 1) & ~t_col(1).isin([3, 4])
    assert tq.expr_to_json(e_t) == rq.expr_to_json(e_r)


@pytest.mark.parametrize("bad", [
    {}, {"op": "nope"}, {"op": "and", "args": []}, {"op": "range", "col": 0},
    "not-an-object"])
def test_parse_expr_rejects_malformed_like_reference(bad):
    with pytest.raises(ValueError) as r_err:
        rq.parse_expr(bad)
    with pytest.raises(ValueError) as t_err:
        tq.parse_expr(bad)
    assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("bad", [
    {"select": {"sum": 5}}, {"select": {"sum": "s", "by": ["a", "b", "c"]}},
    {"select": {"avg": "p", "by": ["region"]}, "limit": 3},
    {"select": {"sum": "s"}, "limit": 3},
    {"select": {"group_count": "region", "by": ["day"]}},
    {"select": {"group_count": True}}, {"select": {"count": False}},
    "SELECT count(*) FROM t WHERE", "SELECT avg(x) FROM t GROUP BY a, b, c",
    "SELECT count(*) FROM t LIMIT 3 x"])
def test_statement_and_sql_errors_match_reference(bad):
    parse = (lambda m: m.parse_sql(bad)) if isinstance(bad, str) else \
        (lambda m: m.parse_statement(bad))
    with pytest.raises(ValueError) as r_err:
        parse(rq)
    with pytest.raises(ValueError) as t_err:
        parse(tq)
    assert str(t_err.value) == str(r_err.value)


def test_statement_descriptors_match_reference():
    for obj in ({"select": {"top_k": {"col": "day", "k": 7}},
                 "where": {"op": "eq", "col": 0, "value": 1}},
                {"select": {"sum": "sales", "by": ["region"]}, "limit": 5},
                {"select": {"count": True, "by": "day"}},
                {"select": {"group_count": "region"}, "limit": 2}):
        r, t = rq.parse_statement(obj), tq.parse_statement(obj)
        assert rq.expr_to_json(r.pop("where")) == tq.expr_to_json(
            t.pop("where")) if r["where"] is not None else True
        assert t == r
    sql = ("SELECT sum(sales) FROM t WHERE day = 3 AND NOT (region IN (1, 2)"
           " OR user BETWEEN 4 AND 9) GROUP BY region LIMIT 5")
    assert tq.parse_sql(sql) == rq.parse_sql(sql)


# -- the service, statement by statement --------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_query_and_batch_match_reference(indexes, table, backend):
    r_svc, t_svc = _services(*indexes, backend, max_rows=100)
    try:
        e_r = (r_col(0) == int(table[5, 0])) & ~(r_col(1) == int(table[5, 1]))
        out = _both(r_svc, t_svc,
                    lambda s: s.query(rq.expr_to_json(e_r),
                                      explain_plan=True))
        want = r_query.naive_eval_rows(table, e_r)
        assert out["count"] == len(want)
        assert out["rows"] == want[:100].tolist()
        assert "AND" in out["plan"]
        vals = [int(v) for v in np.unique(table[:, 0])[[0, 5, 17]]]
        exprs = [rq.expr_to_json(r_col(0) == v) for v in vals]
        outs = _both(r_svc, t_svc, lambda s: s.query_batch(exprs))
        for v, o in zip(vals, outs):
            assert o["count"] == int((table[:, 0] == v).sum())
        assert _stats(t_svc) == _stats(r_svc)
        # repeats inside one batch race for the cache: all but "cached"
        # is held
        outs = [[{k: v for k, v in o.items() if k != "cached"}
                 for o in s.query_batch(exprs + exprs)]
                for s in (r_svc, t_svc)]
        assert outs[1] == outs[0]
    finally:
        r_svc.close()
        t_svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_result_cache_counters_match_reference(indexes, table, backend):
    """Hits, misses, evictions and bytes of the result LRU after the same
    request sequence: repeats, a commutatively reordered query, a rebuild
    (``set_index``), an invalidation and evictions past the entry cap."""
    r_svc, t_svc = _services(*indexes, backend, max_rows=100,
                             cache_entries=3)
    try:
        a, b = int(table[5, 0]), int(table[5, 1])
        seq = [{"op": "and", "args": [{"op": "eq", "col": 0, "value": a},
                                      {"op": "eq", "col": 1, "value": b}]},
               {"op": "and", "args": [{"op": "eq", "col": 1, "value": b},
                                      {"op": "eq", "col": 0, "value": a}]}]
        seq += [{"op": "eq", "col": 0, "value": v} for v in range(5)]
        for q in seq + seq[:2]:
            _both(r_svc, t_svc, lambda s: s.query(q))
        assert t_svc.stats()["cache"] == r_svc.stats()["cache"]
        half = table[:1600]
        cards = [int(table[:, c].max()) + 1 for c in range(3)]
        r_svc.set_index(RIndex.build(half, k=2, cards=cards,
                                     column_names=NAMES))
        t_svc.set_index(TIndex.build(half, k=2, cards=cards,
                                     column_names=NAMES))
        out = _both(r_svc, t_svc, lambda s: s.query(seq[0]))
        assert out["cached"] is False
        r_svc.invalidate_cache()
        t_svc.invalidate_cache()
        for q in seq:
            _both(r_svc, t_svc, lambda s: s.count(q))
        st = _both(r_svc, t_svc, lambda s: s.stats()["cache"])
        assert st["evictions"] > 0 and st["hits"] > 0 and st["entries"] == 3
    finally:
        r_svc.close()
        t_svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_service_matches_reference(table, backend):
    r_sh = RSharded.build(table, shard_rows=992, k=2, column_names=NAMES)
    t_sh = TSharded.build(table, shard_rows=992, k=2, column_names=NAMES)
    r_svc, t_svc = _services(r_sh, t_sh, backend, max_rows=100)
    try:
        e = {"op": "or", "args": [
            {"op": "eq", "col": "dim2", "value": int(table[5, 2])},
            {"op": "not", "arg": {"op": "eq", "col": "dim0",
                                  "value": int(table[5, 0])}}]}
        out = _both(r_svc, t_svc, lambda s: s.query(e, explain_plan=True))
        assert "per-shard plans" in out["plan"]
        for st in ({"select": {"count": True}, "where": e},
                   {"select": {"group_count": "dim0"}, "where": e},
                   {"select": {"top_k": {"col": "dim0", "k": 4}}}):
            _both(r_svc, t_svc, lambda s: s.statement(st))
        assert _both(r_svc, t_svc, lambda s: s.query(e))["cached"] is True
        st = _both(r_svc, t_svc, _stats)
        assert st["n_shards"] == r_sh.n_shards and st["n_rows"] == len(table)
    finally:
        r_svc.close()
        t_svc.close()


# -- HTTP ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_http_endpoint_matches_reference(indexes, table, backend):
    served = Served(*_services(*indexes, backend, max_rows=100))
    try:
        assert served.call("/healthz") == (200, {"ok": True})
        served.call("/stats")
        e = {"op": "or", "args": [
            {"op": "eq", "col": "dim0", "value": int(table[3, 0])},
            {"op": "eq", "col": "dim2", "value": int(table[3, 2])}]}
        out = served.post("/query", {"query": e, "explain": True})
        assert out["count"] == int(((table[:, 0] == table[3, 0])
                                    | (table[:, 2] == table[3, 2])).sum())
        served.post("/query", {"queries": [
            {"op": "eq", "col": 0, "value": 0},
            {"op": "eq", "col": 1, "value": 1}]})
        assert served.post("/query", {"query": e})["cached"] is True
        assert served.call("/stats")[1]["cache"]["hits"] >= 1
        assert served.call("/admin/invalidate", raw=b"") == (200, {"ok": True})
        assert served.post("/query", {"query": e})["cached"] is False
        assert served.call("/query", {"query": {"op": "nope"}})[0] == 400
    finally:
        served.close()


def test_http_structured_errors_match_reference(indexes):
    served = Served(*_services(*indexes, "kernel"))
    try:
        for path, raw in (
                ("/query", b"{not json"), ("/query", b"[1, 2, 3]"),
                ("/query", b'"just a string"'),
                ("/query", json.dumps({"queries": {"op": "eq"}}).encode()),
                ("/query", json.dumps({"select": {"frobnicate": True}})
                 .encode()),
                ("/query", json.dumps({"neither": "shape"}).encode()),
                ("/nope", b"{}"), ("/admin/scrub", b"{}"),
                ("/admin/reload", b"{}"), ("/admin/optimize", b"{}"),
                ("/query", json.dumps({"sql": "SELECT nope"}).encode())):
            code, out = served.call(path, raw=raw)
            assert code in (400, 404) and "code" in out
        assert served.call("/query", {"select": {"count": True}})[1][
            "count"] == 3000
    finally:
        served.close()


def test_http_max_body_bytes_match_reference(indexes):
    served = Served(*_services(*indexes, "kernel"), max_body_bytes=512)
    try:
        big = {"query": {"op": "eq", "col": 0, "value": 0}, "pad": "x" * 2048}
        code, out = served.call("/query", big)
        assert code == 413 and out["code"] == "too_large"
        code, out = served.call("/query", {"select": {"count": True}})
        assert code == 200 and out["count"] == 3000
    finally:
        served.close()


def _measured_rows(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    rows = np.column_stack([rng.integers(0, 7, n), rng.integers(0, 11, n),
                            rng.integers(0, 29, n)]).astype(np.int64)
    return rows, {"sales": rng.integers(-50, 1000, n).astype(np.int64),
                  "price": rng.random(n) * 20.0 - 5.0}


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataset_serve_statements_match_reference(backend):
    """``Dataset.serve`` on a sharded dataset with measures: every statement
    kind as JSON and as SQL, malformed statements, and the LRU's counts."""
    rows, measures = _measured_rows()
    names = ["region", "day", "user"]
    r_ds = r_dataset.Dataset.from_rows(rows, names, sort="none", shards=3,
                                       measures=measures)
    t_ds = t_dataset.Dataset.from_rows(rows, names, sort="none", shards=3,
                                       measures=measures, device="cpu")
    t_svc = t_ds.serve(pool_workers=2, backend=backend)
    assert t_svc.device.type == "cpu"
    served = Served(r_ds.serve(pool_workers=2, backend="ewah"), t_svc)
    where = {"op": "and", "args": [
        {"op": "in", "col": "region", "values": [1, 2, 5]},
        {"op": "not", "arg": {"op": "eq", "col": "user", "value": 4}}]}
    try:
        for sel in ({"count": True}, {"group_count": "day"},
                    {"top_k": {"col": "day", "k": 3}},
                    {"top_k": {"col": "user", "k": 4, "measure": "sales"}},
                    {"sum": "sales"}, {"avg": "price"}, {"min": "sales"},
                    {"max": "price"}, {"sum": "sales", "by": ["day"]},
                    {"avg": "price", "by": ["day", "region"]},
                    {"count": True, "by": ["region", "user"]}):
            for body in ({"select": sel}, {"select": sel, "where": where}):
                served.post("/query", body)
        served.post("/query", {"select": {"sum": "sales", "by": ["day"]},
                               "limit": 3})
        for sql in ("SELECT count(*) FROM t WHERE region IN (1, 2) AND "
                    "NOT user = 3",
                    "SELECT sum(sales) FROM t WHERE day BETWEEN 2 AND 6 "
                    "GROUP BY region LIMIT 2",
                    "SELECT avg(price) FROM t GROUP BY day, region",
                    "SELECT max(sales) FROM t WHERE (day = 1 OR day = 9)"):
            served.post("/query", {"sql": sql})
        mask = np.isin(rows[:, 0], [1, 2, 5]) & (rows[:, 2] != 4)
        out = served.post("/query", {"select": {"sum": "sales"},
                                     "where": where})
        assert out["value"] == int(measures["sales"][mask].sum())
        for bad in ({"select": {"nope": 1}}, {"select": {"count": False}},
                    {"select": {"top_k": {"col": "day"}}},
                    {"select": {"group_count": "no_such_col"}},
                    {"select": {"sum": "no_such_measure"}}):
            assert served.call("/query", bad)[0] == 400
        served.call("/stats")
    finally:
        served.close()


def test_group_matrix_cache_budget_matches_reference():
    rows, measures = _measured_rows(1500)
    names = ["region", "day", "user"]
    r_ds = r_dataset.Dataset.from_rows(rows, names, measures=measures)
    t_ds = t_dataset.Dataset.from_rows(rows, names, measures=measures,
                                       device="cpu")
    r_svc, t_svc = _services(r_ds.index, t_ds.index, "kernel",
                             cache_entries=64, cache_bytes=1 << 20)
    try:
        for _ in range(2):
            _both(r_svc, t_svc,
                  lambda s: s.group_agg("sum", "sales", ["day", "region"]))
        st = _both(r_svc, t_svc, lambda s: s.stats()["cache"])
        assert st["bytes"] > 0 and st["hits"] == 1
    finally:
        r_svc.close()
        t_svc.close()


def test_http_from_many_threads_matches_sequential(table):
    """Statements from many HTTP threads at once on one sharded index under
    the kernel path, the query pool and the shard thread pool all busy,
    with a short thread switch interval: every answer equals the
    sequential one, operands uploaded by racing statements included."""
    sh = TSharded.build(table, shard_rows=992, k=2, column_names=NAMES)
    svc = tq.QueryService(sh, backend="kernel", device="cpu", max_rows=50,
                          cache_entries=0, shard_processes=0)
    srv, port = tq.serve_in_thread(svc)
    base = f"http://127.0.0.1:{port}/query"
    bodies = []
    for v in range(6):
        e = {"op": "and", "args": [
            {"op": "in", "col": 0, "values": [v, v + 3, v + 7]},
            {"op": "not", "arg": {"op": "eq", "col": 1, "value": v}}]}
        bodies += [{"query": e}, {"select": {"group_count": 0}, "where": e},
                   {"queries": [e, {"op": "eq", "col": 2, "value": v}]}]

    def post(body):
        req = urllib.request.Request(base, data=json.dumps(body).encode())
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    interval = sys.getswitchinterval()
    try:
        want = [post(b) for b in bodies]
        n_operands = [len(shard.dense_cache) for shard in sh.shards]
        for shard in sh.shards:
            shard.dense_cache.clear()
            for column in shard.columns:
                column.invalidate_sizes()  # and its group-by run catalog
        # fresh shard result caches: every statement computes again
        svc.set_index(TSharded(sh.shards, column_names=NAMES))
        sys.setswitchinterval(1e-5)
        with ThreadPoolExecutor(16) as tp:
            got = list(tp.map(post, bodies * 2))
        assert got == want * 2
        assert [len(shard.dense_cache) for shard in sh.shards] == n_operands
    finally:
        sys.setswitchinterval(interval)
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_http_listen_backlog_holds_many_clients(indexes):
    """The reference's server keeps socketserver's listen backlog of 5, so
    more clients connecting at one instant than that can be reset (ROADMAP
    Queue 3); the port's is 128: 64 clients at once all get answers."""
    r_srv = rq.make_server(rq.QueryService(indexes[0]), port=0)
    assert r_srv.request_queue_size == 5
    r_srv.server_close()
    r_srv.RequestHandlerClass.service.close()
    svc = tq.QueryService(indexes[1], backend="ewah", device="cpu",
                          cache_entries=0)
    srv, port = tq.serve_in_thread(svc)
    assert srv.request_queue_size == 128
    body = json.dumps({"select": {"count": True},
                       "where": {"op": "eq", "col": 0, "value": 3}}).encode()

    def post(_):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/query",
                                     data=body)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["count"]

    try:
        with ThreadPoolExecutor(64) as tp:
            outs = list(tp.map(post, range(256)))
        assert all(o == outs[0] for o in outs)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


# -- a store directory: warm start, reload, watcher, scrub, live, optimize ----

def _store(tmp_path, table, name="shards", cards=None):
    """The same sharded store saved by the reference, and a copy for the
    port (the packages write the same bytes)."""
    cards = cards or [int(table[:, c].max()) + 1 for c in range(3)]
    r_sh = RSharded.build(table, shard_rows=1024, k=2, cards=cards,
                          column_names=NAMES)
    r_dir, t_dir = str(tmp_path / f"r-{name}"), str(tmp_path / f"t-{name}")
    r_sh.save(r_dir)
    shutil.copytree(r_dir, t_dir)
    return cards, r_dir, t_dir


def test_warm_start_reload_and_replace_match_reference(tmp_path, table):
    cards, r_dir, t_dir = _store(tmp_path, table)
    r_svc = rq.QueryService.from_dir(r_dir, shard_processes=0)
    t_svc = tq.QueryService.from_dir(t_dir, device="cpu",
                                     backend="kernel", shard_processes=0)
    try:
        q = {"op": "and", "args": [
            {"op": "eq", "col": "dim0", "value": 1},
            {"op": "range", "col": "dim1", "lo": 0, "hi": 20}]}
        _both(r_svc, t_svc, lambda s: s.query(q))
        assert _both(r_svc, t_svc, lambda s: s.reload_from_dir()) == {
            "reloaded": [], "full": False, "n_shards": 3}
        assert _both(r_svc, t_svc, lambda s: s.check_reload()) is None
        variant = table[:1024].copy()
        variant[:, 0] = 0
        r_write_shard(r_dir, 0, RBuilder(cards, k=2, column_names=NAMES)
                      .append(variant).finish())
        t_write_shard(t_dir, 0, TBuilder(cards, k=2, column_names=NAMES)
                      .append(variant).finish())
        assert _both(r_svc, t_svc, lambda s: s.reload_from_dir())[
            "reloaded"] == [0]
        q0 = {"op": "eq", "col": "dim0", "value": 0}
        assert _both(r_svc, t_svc, lambda s: s.query(q0))["count"] >= 1024
        variant[:, 1] = 1
        r_svc.replace_shard(1, RBuilder(cards, k=2, column_names=NAMES)
                            .append(variant).finish())
        t_svc.replace_shard(1, TBuilder(cards, k=2, column_names=NAMES)
                            .append(variant).finish())
        assert _both(r_svc, t_svc, lambda s: s.reload_from_dir())[
            "reloaded"] == []
        _both(r_svc, t_svc, lambda s: s.query(q))
        for f in sorted(os.listdir(r_dir)):
            with open(os.path.join(r_dir, f), "rb") as a, \
                    open(os.path.join(t_dir, f), "rb") as b:
                assert a.read() == b.read(), f
        _both(r_svc, t_svc, _stats)
    finally:
        r_svc.close()
        t_svc.close()
    mem = tq.QueryService(TIndex.build(table, k=2, column_names=NAMES),
                          device="cpu")
    with pytest.raises(ValueError):
        mem.reload_from_dir()
    mem.close()


def test_cache_ttl_matches_reference(tmp_path, table, monkeypatch):
    _, r_dir, t_dir = _store(tmp_path, table)
    r_svc = rq.QueryService.from_dir(r_dir, cache_ttl=30.0,
                                     shard_processes=0)
    t_svc = tq.QueryService.from_dir(t_dir, cache_ttl=30.0, device="cpu",
                                     shard_processes=0)
    try:
        now = [0.0]
        for s in (r_svc, t_svc):
            monkeypatch.setattr(s.cache, "_clock", lambda: now[0])
        q = {"op": "eq", "col": "dim0", "value": 1}
        assert not _both(r_svc, t_svc, lambda s: s.query(q))["cached"]
        assert _both(r_svc, t_svc, lambda s: s.query(q))["cached"]
        now[0] = 31.0
        assert not _both(r_svc, t_svc, lambda s: s.query(q))["cached"]
        st = _both(r_svc, t_svc, lambda s: s.stats()["cache"])
        assert st["expired"] == 1 and st["ttl"] == 30.0
    finally:
        r_svc.close()
        t_svc.close()


def test_watcher_picks_up_shard_swap(tmp_path, table):
    """The manifest watcher swaps an out-of-band shard replacement in with
    no reload call; the sibling shards' result caches stay warm; the new
    answer is the reference's over the same files."""
    cards, r_dir, t_dir = _store(tmp_path, table)
    svc = tq.QueryService.from_dir(t_dir, device="cpu", backend="kernel",
                                   shard_processes=0)
    try:
        e = {"op": "and", "args": [
            {"op": "eq", "col": "dim0", "value": 1},
            {"op": "not", "arg": {"op": "eq", "col": "dim1", "value": 2}}]}
        svc.query(e)
        warm = [c["entries"] for c in svc.index.cache_stats()]
        assert all(n > 0 for n in warm)
        gen0 = svc.index.generation
        variant = table[:1024].copy()
        variant[:, 0] = 0
        t_write_shard(t_dir, 0, TBuilder(cards, k=2, column_names=NAMES)
                      .append(variant).finish())
        svc.start_watcher(interval=0.05)
        deadline = time.monotonic() + 30
        while svc.index.generation == gen0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.index.generation > gen0, "watcher never reloaded"
        after = [c["entries"] for c in svc.index.cache_stats()]
        assert after[0] == 0 and after[1:] == warm[1:]
        q0 = {"op": "eq", "col": "dim0", "value": 0}
        ref = rq.QueryService.from_dir(t_dir, shard_processes=0)
        assert svc.query(q0) == ref.query(q0)
        ref.close()
        svc.stop_watcher()
        assert svc._watcher is None
    finally:
        svc.close()


def test_scrub_http_matches_reference(tmp_path, table):
    _, r_dir, t_dir = _store(tmp_path, table)
    served = Served(rq.QueryService.from_dir(r_dir, shard_processes=0),
                    tq.QueryService.from_dir(t_dir, device="cpu",
                                             shard_processes=0),
                    paths=(r_dir, t_dir))
    try:
        out = served.post("/admin/scrub", {})
        assert out["ok"] is True and out["n_shards"] == 3
        shard = sorted(f for f in os.listdir(t_dir) if f.endswith(".ridx"))[1]
        for d in (r_dir, t_dir):
            with open(os.path.join(d, shard), "r+b") as f:
                f.seek(64 + 9)
                byte = f.read(1)
                f.seek(64 + 9)
                f.write(bytes([byte[0] ^ 0xFF]))
        out = served.post("/admin/scrub", {})
        assert out["ok"] is False and out["n_corrupt_segments"] >= 1
    finally:
        served.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_http_live_ingest_delete_compact_matches_reference(tmp_path,
                                                           backend):
    rng = np.random.default_rng(11)
    cards = [8, 30, 100]
    rows = np.stack([rng.integers(0, c, 3000) for c in cards], axis=1)
    names = ["region", "day", "user"]
    dirs = [str(tmp_path / "r"), str(tmp_path / "t")]
    r_dataset.Dataset.from_rows(rows, names, sort="lex", shards=2,
                                cards=cards).save(dirs[0])
    shutil.copytree(dirs[0], dirs[1])
    served = Served(rq.QueryService.from_dir(dirs[0], live=True,
                                             shard_processes=0),
                    tq.QueryService.from_dir(dirs[1], live=True,
                                             shard_processes=0,
                                             device="cpu", backend=backend))
    try:
        extra = np.stack([rng.integers(0, c, 128) for c in cards], axis=1)
        assert served.post("/ingest", {"rows": extra.tolist()})[
            "appended"] == 128
        out = served.post("/delete", {"where": {"op": "eq", "col": "day",
                                                "value": 1}})
        full = np.concatenate([rows, extra])
        alive = full[:, 1] != 1
        assert out["removed"] == int((~alive).sum())
        q = {"select": {"count": True},
             "where": {"op": "eq", "col": "region", "value": 2}}
        want = int(((full[:, 0] == 2) & alive).sum())
        assert served.post("/query", q)["count"] == want
        served.post("/query", {"select": {"group_count": "user"},
                               "where": q["where"]})
        served.call("/stats")
        assert served.post("/admin/compact", {})["epoch"] == 1
        assert served.post("/query", q)["count"] == want
        served.post("/query", {"query": q["where"]})
        served.call("/stats")
        for path, body in (("/ingest", {}), ("/ingest", {"rows": [[1, 2]]}),
                           ("/delete", {}),
                           ("/delete", {"where": {"op": "x"}})):
            assert served.call(path, body)[0] == 400
    finally:
        served.close()
    for f in sorted(os.listdir(dirs[0])):
        with open(os.path.join(dirs[0], f), "rb") as a, \
                open(os.path.join(dirs[1], f), "rb") as b:
            assert a.read() == b.read(), f


def test_http_optimize_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    n = 6000
    zipf = (rng.zipf(1.6, n) - 1) % 300
    rows = np.stack([rng.integers(0, 32, n), rng.permutation(300)[zipf],
                     rng.integers(0, 50, n)], axis=1).astype(np.int64)
    names = ["store", "sku", "day"]
    dirs = [str(tmp_path / "r"), str(tmp_path / "t")]
    r_dataset.Dataset.from_rows(rows, names, cards=[32, 300, 50],
                                sort="none", k=2, shards=2).save(dirs[0])
    shutil.copytree(dirs[0], dirs[1])
    served = Served(rq.QueryService.from_dir(dirs[0], shard_processes=0),
                    tq.QueryService.from_dir(dirs[1], shard_processes=0,
                                             device="cpu", backend="kernel"))
    try:
        q = {"op": "eq", "col": "sku", "value": int(rows[0, 1])}
        before = served.post("/query", {"query": q})
        out = served.post("/admin/optimize", {})
        assert out["opt_epoch"] == 1 and out["reloaded"] == [0, 1]
        assert served.post("/query", {"query": q})["count"] == \
            before["count"]
        stats = served.call("/stats")[1]
        assert stats["layout"]["order"] == out["order"]
    finally:
        served.close()


# -- devices and the smoke's serving phase ------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, table):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    idx = TIndex.build(table[:512], k=2, column_names=NAMES)
    _, _, t_dir = _store(tmp_path, table[:2048])
    ds = t_dataset.Dataset.open(t_dir, device="cpu")
    for call in (lambda: tq.QueryService(idx),
                 lambda: tq.QueryService.from_dir(t_dir),
                 lambda: ds.serve(device="cuda"),
                 lambda: tq.main(["--index-dir", t_dir, "--port", "0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    svc = ds.serve(shard_processes=0)
    assert svc.device.type == "cpu"
    svc.close()


def test_default_shard_pool_forks_only_on_the_cpu(tmp_path, table):
    """A store-backed sharded service defaults to the reference's forked
    process pool on the CPU, and to threads on a CUDA device (forked
    workers run host EWAH and never reach the card)."""
    import torch
    _, r_dir, t_dir = _store(tmp_path, table[:2048])
    ref = rq.QueryService.from_dir(r_dir, shard_processes=0)
    svc = tq.QueryService.from_dir(t_dir, device="cpu", shard_processes=0)
    try:
        ref.shard_processes = svc.shard_processes = None
        assert svc._resolve_shard_processes() == \
            ref._resolve_shard_processes() > 0
        svc.device = torch.device("cuda")
        assert svc._resolve_shard_processes() == 0
        svc.shard_processes = 3
        assert svc._resolve_shard_processes() == 3
    finally:
        svc.close()
        ref.close()


def test_query_api_cli_serves_on_cpu(tmp_path):
    """``python -m repro_torch.serve.query_api --device cpu`` builds the
    demo index and answers over HTTP like the reference's CLI."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.query_api", "--device",
         "cpu", "--rows", "2000", "--shards", "2", "--port", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving 2000 rows" in line and "device=cpu" in line, line
        body = {"select": {"count": True},
                "where": {"op": "eq", "col": "region", "value": 3}}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/query",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
        idx = rq._demo_index(2000, 2)
        svc = rq.QueryService(idx)
        assert got == svc.statement(body)
        svc.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_SMOKE_SCRIPT = r"""
import importlib.util
import sys
import tempfile
from pathlib import Path
import torch

root = Path(sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              root / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from repro_torch.core import Dataset, col, synth
from repro_torch.kernels import logical_reduce as lr, word_logical as wl

torch.cuda.synchronize = lambda *a: None
torch.cuda.empty_cache = lambda *a: None
torch.cuda.memory_allocated = lambda *a: 0
plain = lr.fold_plain


def counted(*args):             # a CPU "launch" per plain fold
    lr.launches += 1
    return plain(*args)


lr.fold_plain = counted
smoke.DEVICE = "cpu"
smoke.gpu_memory = lambda: ("0 MiB", {})     # no nvidia-smi here
table, measures = smoke.make_table(synth, 1 << 12, smoke.SEED)
ds = Dataset.from_rows(table, smoke.NAMES, sort="lex", measures=measures,
                       device="cpu")
stmts, _, _ = smoke.statements(col, ds.table)
memory = smoke.run_backend(ds, stmts, "ewah", torch, wl, lr)[0]
with tempfile.TemporaryDirectory() as d:
    store = Path(d) / "sorted"
    ds.shard(smoke.STORE_SHARDS).save(str(store))
    launches = smoke.serve_phase(torch, wl, lr, Dataset, col, store,
                                 ds.table, ds.index.measure("sales"), memory)
assert launches["http_cached"]["logical_reduce"] == 0, launches
assert all(launches[k]["logical_reduce"] > 0
           for k in ("http_cold", "http_warm", "worker")), launches
print("OK")
"""


def test_smoke_serve_phase_on_cpu(tmp_path):
    """The smoke's serving phase end to end on the CPU at a tiny size (the
    plain fold counted as a launch), in a fresh interpreter that imports
    only the port: it forks a shard process pool and spawns workers."""
    res = subprocess.run([sys.executable, "-c", _SMOKE_SCRIPT, ROOT],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=dict(os.environ,
                                                     PYTHONPATH=SRC))
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert res.stdout.strip().endswith("OK")
    for line in ("http cold", "http cached", "auto: ShardProcessPool",
                 "live serve", "cluster after SIGKILL", "in-process worker"):
        assert line in res.stdout
