"""The port's RPC wire, shard workers and coordinator against the
reference's, on the CPU.

Wire messages and frames are byte-identical, fault injection draws the
same sequence, and every worker response encodes to the reference
worker's bytes.  The coordinator runs over in-process ``WorkerServer``
threads (real TCP sockets) on ``device="cpu"``: its answers equal the
reference's single-process service's, exactly, through failover,
re-placement, structural degradation, corrupt and slow responses, remote
faults and a rolling reload.  The RPC crosses packages both ways (a port
coordinator over reference workers, a reference coordinator over port
workers), and ``LocalCluster`` spawns real ``--device cpu`` workers.
Deadlines are 30 s, far above any statement here: the tests assert on
counters and answers, never on wall time.
"""
import json
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core import ShardedIndex as RSharded
from repro.core import dataset as r_dataset
from repro.core import lex_sort
from repro.core import query as r_query
from repro.core.expr import col as r_col
from repro.distributed import cluster as r_cluster
from repro.distributed import wire as r_wire
from repro.launch import cluster as r_launch
from repro.serve import query_api as rq
from repro.serve import worker_api as r_worker
from repro_torch.core import BitmapIndex as TIndex
from repro_torch.distributed import cluster as t_cluster
from repro_torch.distributed import wire as t_wire
from repro_torch.launch import cluster as t_launch
from repro_torch.serve import query_api as tq
from repro_torch.serve import worker_api as t_worker

NAMES = ["dim0", "dim1", "dim2"]
BACKENDS = ["ewah", "kernel", "auto"]
BACKEND = "kernel"          # the port's workers run its device path
POLICY = dict(deadline_s=30.0, retries=2, backoff_s=0.01,
              hedge_after_s=0.15)


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


EXPRS = [rq.expr_to_json(e) for e in (
    r_col("dim0") == 1, (r_col(0) == 1) & ~(r_col(1) == 2),
    ((r_col(0) == 0) | (r_col(2) == 3)) & (r_col(1) >= 1),
    r_col(2).isin([0, 2, 5]))]


def _rows(n, seed):
    """A lex-sorted table of narrow columns (cardinalities 6, 20, 50): the
    kernel path's plain version folds once per group on the CPU."""
    rng = np.random.default_rng(seed)
    table = np.stack([rng.integers(0, c, n) for c in (6, 20, 50)], axis=1)
    return table[lex_sort(table)]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    table = _rows(4000, 7)
    idx = RSharded.build(table, shard_rows=640, k=2, column_names=NAMES)
    d = str(tmp_path_factory.mktemp("cluster-store"))
    idx.save(d)
    return table, idx, d


@pytest.fixture(scope="module")
def mono(store):
    svc = rq.QueryService(store[1], backend="ewah", shard_processes=0)
    yield svc
    svc.close()


def _servers(d, n=3, backend=BACKEND, package="port"):
    if package == "port":
        return [t_worker.WorkerServer(t_worker.ShardWorker(
            d, [], backend=backend, device="cpu")).start() for _ in range(n)]
    return [r_worker.WorkerServer(r_worker.ShardWorker(
        d, [], backend="ewah")).start() for _ in range(n)]


def _coordinator(d, servers, package="port", replication=2, backend=BACKEND,
                 **policy):
    mod = t_cluster if package == "port" else r_cluster
    svc = mod.ClusterService(d, [s.address for s in servers],
                             replication=replication,
                             policy=mod.Policy(**{**POLICY, **policy}),
                             backend=backend if package == "port"
                             else "ewah")
    return svc.start(monitor=False)


@pytest.fixture()
def cluster(store):
    servers = _servers(store[2])
    svc = _coordinator(store[2], servers)
    yield servers, svc
    svc.close()
    for s in servers:
        s.stop()


def _same(got, want):
    """A coordinator answer against the mono service's: exact, and equal
    on every key both have (the count, rows, vector or top-k)."""
    assert got["exact"] is True and got["missing_shards"] == []
    keys = (set(got) & set(want)) - {"cached"}
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert keys & {"count", "counts", "top", "rows", "value", "values"}


def _statements(svc, mono, e):
    for call in (lambda s: s.count(e), lambda s: s.group_count("dim1", e),
                 lambda s: s.top_k("dim2", 3, e), lambda s: s.query(e)):
        _same(call(svc), call(mono))


# -- wire ---------------------------------------------------------------------

WIRE_CASES = {
    "arrays": ({"op": "gcount", "shards": [0, 2], "nested": {"a": [1, 2]}},
               {"g0": np.arange(7, dtype=np.int64),
                "w2": np.array([5, 0xFFFFFFFF], dtype=np.uint32),
                "empty": np.empty(0, dtype=np.int64)}),
    "json_only": ({"op": "health", "ok": True, "pid": 12, "x": None,
                   "f": 0.1, "s": "é"}, None),
    "floats": ({"op": "gagg", "shapes": {"3": [4, 5]}},
               {"gs3": np.linspace(-1, 1, 20),
                "gm3": np.arange(20, dtype=np.float32)}),
    "big_endian": ({}, {"v": np.arange(5, dtype=">i8")}),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_wire_messages_encode_like_reference(case):
    obj, arrays = WIRE_CASES[case]
    blob = r_wire.encode_msg(obj, arrays)
    assert t_wire.encode_msg(obj, arrays) == blob
    t_obj, t_arrs = t_wire.decode_msg(blob)
    r_obj, r_arrs = r_wire.decode_msg(blob)
    assert t_obj == r_obj
    assert set(t_arrs) == set(r_arrs)
    for k in r_arrs:
        assert t_arrs[k].dtype == r_arrs[k].dtype
        np.testing.assert_array_equal(t_arrs[k], r_arrs[k])


def test_wire_decode_rejects_malformed_like_reference():
    payload = r_wire.encode_msg({"x": 1}, {"a": np.arange(8, dtype=np.int64)})
    for bad in (b"\x01", b"\xff\xff\xff\xff{}", payload[:-4],
                b"\x02\x00\x00\x00[]", b"\x03\x00\x00\x00{x}"):
        with pytest.raises(r_wire.WireError) as r_err:
            r_wire.decode_msg(bad)
        with pytest.raises(t_wire.WireError) as t_err:
            t_wire.decode_msg(bad)
        assert str(t_err.value) == str(r_err.value)


def _frame_bytes(wire, payload, injector=None):
    a, b = socket.socketpair()
    try:
        action = wire.send_frame(a, wire.KIND_RESP, payload,
                                 injector=injector)
        if action == "disconnect":
            return action, b""
        a.close()
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return action, b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


def test_frames_match_reference_byte_for_byte():
    payload = r_wire.encode_msg({"hello": 1},
                                {"v": np.arange(100, dtype=np.int64)})
    assert _frame_bytes(t_wire, payload) == _frame_bytes(r_wire, payload)
    for seed in range(6):
        cfg = dict(seed=seed, corrupt=0.5, drop=0.2, disconnect=0.1)
        t_inj, r_inj = t_wire.FaultInjector(**cfg), r_wire.FaultInjector(**cfg)
        for _ in range(4):
            assert _frame_bytes(t_wire, payload, t_inj) == \
                _frame_bytes(r_wire, payload, r_inj)
        assert t_inj.counts == r_inj.counts
    # each package reads the other's frames, and both catch a flipped byte
    for send, recv in ((r_wire, t_wire), (t_wire, r_wire)):
        a, b = socket.socketpair()
        try:
            send.send_frame(a, send.KIND_REQ, payload)
            assert recv.recv_frame(b, deadline=time.monotonic() + 30) == \
                (recv.KIND_REQ, payload)
            send.send_frame(a, send.KIND_RESP, payload,
                            injector=send.FaultInjector(seed=1, corrupt=1.0))
            with pytest.raises(recv.WireCorruptError):
                recv.recv_frame(b, deadline=time.monotonic() + 30)
        finally:
            a.close()
            b.close()


def test_frame_size_cap_like_reference():
    for wire in (t_wire, r_wire):
        a, b = socket.socketpair()
        try:
            wire.send_frame(a, wire.KIND_REQ, b"x" * 4096)
            with pytest.raises(wire.WireTooLargeError):
                wire.recv_frame(b, deadline=time.monotonic() + 30,
                                max_bytes=100)
        finally:
            a.close()
            b.close()
    assert t_wire.DEFAULT_MAX_BYTES == r_wire.DEFAULT_MAX_BYTES


def test_fault_injector_matches_reference():
    cfg = dict(seed=42, drop=0.2, delay=0.2, corrupt=0.2, disconnect=0.1)
    t_inj, r_inj = t_wire.FaultInjector(**cfg), r_wire.FaultInjector(**cfg)
    seq = [r_inj.action() for _ in range(200)]
    assert [t_inj.action() for _ in range(200)] == seq
    assert set(seq) > {None}
    assert [t_inj.corrupt_at(1000) for _ in range(20)] == \
        [r_inj.corrupt_at(1000) for _ in range(20)]
    assert t_wire.FaultInjector.from_config(r_inj.to_config()).to_config() \
        == r_inj.to_config()
    assert t_wire.FaultInjector.from_config(None) is None


def test_round_robin_placement_matches_reference():
    for args in ((6, 3, 2), (4, 2, 5), (7, 3, 1), (5, 4, 3)):
        assert t_cluster.round_robin_placement(*args) == \
            r_cluster.round_robin_placement(*args)
    assert t_cluster.round_robin_placement(4, 3, 2, hot_shards=[1]) == \
        r_cluster.round_robin_placement(4, 3, 2, hot_shards=[1])
    with pytest.raises(t_cluster.ClusterError):
        t_cluster.round_robin_placement(3, 0)


# -- worker responses ---------------------------------------------------------

@pytest.fixture(scope="module")
def measured_store(tmp_path_factory):
    rng = np.random.default_rng(5)
    rows = np.column_stack([rng.integers(0, c, 3000)
                            for c in (7, 11, 29)]).astype(np.int64)
    d = str(tmp_path_factory.mktemp("measured"))
    r_dataset.Dataset.from_rows(
        rows, ["a", "b", "c"], shards=3,
        measures={"sales": rng.integers(-50, 1000, 3000),
                  "price": rng.random(3000) * 20.0 - 5.0}).save(d)
    return d


@pytest.mark.parametrize("backend", BACKENDS)
def test_worker_responses_encode_like_reference(measured_store, backend):
    """Every op of a port worker encodes to the reference worker's bytes:
    counts, count vectors, measure partials, grouped partials, EWAH
    slices as uint32 words, and the admin ops."""
    d = measured_store
    t_w = t_worker.ShardWorker(d, [0, 2], backend=backend, device="cpu")
    r_w = r_worker.ShardWorker(d, [0, 2], backend="ewah")
    where = {"op": "and", "args": [{"op": "in", "col": 0, "values": [1, 4]},
                                   {"op": "not", "arg": {"op": "eq",
                                                         "col": 2,
                                                         "value": 3}}]}
    reqs = []
    for w in (None, where):
        reqs += [{"op": "count", "shards": [0, 1, 2], "where": w},
                 {"op": "gcount", "shards": [0, 2], "col": 1, "where": w},
                 {"op": "agg", "shards": [0, 2], "measure": "sales",
                  "where": w},
                 {"op": "agg", "shards": [2], "measure": "price",
                  "where": w},
                 {"op": "gagg", "shards": [0, 2], "measure": "price",
                  "cols": [0, 1], "where": w},
                 {"op": "gagg", "shards": [0, 2], "measure": None,
                  "cols": [2], "where": w}]
    reqs += [{"op": "execute", "shards": [0, 1, 2], "where": where}]
    reqs += [{"op": "health"}, {"op": "stats"}, {"op": "scrub"},
             {"op": "assign", "shards": [1]}, {"op": "retire", "shards": [0]},
             {"op": "reload"}, {"op": "fault", "config": {"seed": 3}},
             {"op": "stats"}, {"op": "fault", "config": None}]
    for req in reqs:
        out = [w.handle(req, {}) for w in (r_w, t_w)]
        blobs = [t_wire.encode_msg(o, a) for o, a in out]
        assert blobs[1] == blobs[0], req
        for name, arr in out[1][1].items():
            if name.startswith("w"):
                assert arr.dtype == np.uint32
    for bad in ({"op": "frobnicate"}, {"op": "gcount", "col": "x"},
                {"op": "agg", "measure": 3},
                {"op": "gagg", "cols": [0, 1, 2]}):
        with pytest.raises(ValueError) as r_err:
            r_w.handle(bad, {})
        with pytest.raises(ValueError) as t_err:
            t_w.handle(bad, {})
        assert str(t_err.value) == str(r_err.value)


def test_worker_assign_retire_missing(store):
    w = t_worker.ShardWorker(store[2], [0, 1], backend=BACKEND, device="cpu")
    out, _ = w.handle({"op": "count", "shards": [0, 1, 2], "where": None}, {})
    assert sorted(map(int, out["counts"])) == [0, 1]
    assert out["missing"] == [2]
    assert w.assign([2])["opened"] == [2]
    out, _ = w.handle({"op": "count", "shards": [2], "where": None}, {})
    assert out["missing"] == []
    assert w.retire([0])["retired"] == [0]
    assert sorted(w.shards) == [1, 2]
    rep = w.scrub()
    assert rep["ok"] and rep["n_corrupt_segments"] == 0


def test_worker_server_error_frame(store):
    srv = _servers(store[2], n=1)[0]
    try:
        w = t_worker.ShardWorker(store[2], [0], backend=BACKEND,
                                 device="cpu")
        srv.worker = w
        sock = socket.create_connection((srv.host, srv.port), timeout=30)
        with pytest.raises(t_wire.WorkerError):
            t_wire.call(sock, {"op": "nope"}, deadline=time.monotonic() + 30)
        out, _ = t_wire.call(sock, {"op": "health"},
                             deadline=time.monotonic() + 30)
        assert out["ok"] and out["shards"] == [0]
        sock.close()
    finally:
        srv.stop()


# -- the coordinator ----------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_cluster_matches_mono(store, mono, backend):
    table, idx, d = store
    servers = _servers(d, backend=backend)
    svc = _coordinator(d, servers, backend=backend)
    try:
        for e in EXPRS:
            _statements(svc, mono, e)
            assert svc.query(e)["rows"] == r_query.naive_eval_rows(
                table, rq.parse_expr(e), NAMES)[:svc.max_rows].tolist()
        assert svc.stats()["counters"]["degraded_queries"] == 0
    finally:
        svc.close()
        for s in servers:
            s.stop()


def test_cluster_statement_and_cache(cluster, mono):
    _servers_, svc = cluster
    st = {"select": {"top_k": {"col": "dim2", "k": 4}}, "where": EXPRS[1]}
    assert svc.statement(st)["top"] == mono.statement(st)["top"]
    again = svc.statement(st)
    assert again["cached"] is True and again["exact"] is True
    svc.invalidate_cache()
    assert svc.statement(st)["cached"] is False
    sql = "SELECT count(*) FROM t WHERE dim0 IN (1, 2) GROUP BY dim1"
    _same(svc.sql(sql), mono.sql(sql))
    for call in (lambda: svc.ingest([[0, 0, 0]]),
                 lambda: svc.delete(EXPRS[0]), lambda: svc.compact()):
        with pytest.raises(ValueError):
            call()


def test_worker_crash_replica_failover(cluster, mono):
    servers, svc = cluster
    ref = mono.count(EXPRS[2])["count"]
    svc.count(EXPRS[2])
    servers[0].stop()
    svc.cache.clear()
    out = svc.count(EXPRS[2])
    assert out["count"] == ref and out["exact"]
    for _ in range(svc.policy.fail_threshold + 1):
        svc.probe_all()
    stats = svc.stats()
    assert stats["workers"][0]["up"] is False
    assert stats["counters"]["evictions"] >= 1
    live = {w for w in range(3) if stats["workers"][w]["up"]}
    for reps in stats["placement"]:
        assert len([w for w in reps if w in live]) >= 2
    svc.cache.clear()
    for e in EXPRS:
        _statements(svc, mono, e)
    assert svc.stats()["counters"]["degraded_queries"] == 0


def test_repair_is_level_triggered(store, mono):
    d = store[2]
    servers = _servers(d)
    svc = _coordinator(d, servers, fail_threshold=1)
    try:
        svc._note_failure(0, "simulated outage")
        assert svc.stats()["workers"][0]["up"] is False
        servers[1].stop()
        for _ in range(2):
            svc.probe_all()
        stats = svc.stats()
        live = {w for w in range(3) if stats["workers"][w]["up"]}
        assert live == {0, 2}
        for reps in stats["placement"]:
            assert len([w for w in reps if w in live]) >= 2
        svc.cache.clear()
        _statements(svc, mono, EXPRS[0])
    finally:
        svc.close()
        servers[0].stop()
        servers[2].stop()


def test_all_replicas_down_degrades_structurally(store):
    _table, idx, d = store
    servers = _servers(d, n=2)
    svc = _coordinator(d, servers, replication=1, retries=1,
                       fail_threshold=10 ** 6)
    try:
        whole = svc.count(None)
        assert whole["exact"] and whole["count"] == idx.n_rows
        servers[0].stop()
        svc.cache.clear()
        out = svc.count(None)
        dead = [s for s, reps in enumerate(svc.placement) if reps == [0]]
        assert out["exact"] is False and out["missing_shards"] == dead
        rows = np.diff(idx.offsets)
        assert out["covered_rows"] == idx.n_rows - sum(int(rows[s])
                                                       for s in dead)
        assert out["count"] == out["covered_rows"]
        assert out["cached"] is False and svc.count(None)["cached"] is False
        g = svc.group_count("dim0", None)
        assert g["exact"] is False and g["missing_shards"] == dead
        assert svc.stats()["counters"]["degraded_queries"] >= 3
    finally:
        svc.close()
        servers[1].stop()


def test_corrupt_responses_detected_and_retried(cluster, mono):
    servers, svc = cluster
    ref = mono.count(EXPRS[1])["count"]
    servers[1].worker.fault = t_wire.FaultInjector(seed=3, corrupt=1.0)
    for _ in range(3):
        svc.cache.clear()
        out = svc.count(EXPRS[1])
        assert out["count"] == ref and out["exact"]
    assert svc.stats()["counters"]["failures"] >= 1
    assert servers[1].worker.fault.counts["corrupt"] >= 1


def test_slow_worker_hedged(store, mono):
    d = store[2]
    servers = _servers(d)
    svc = _coordinator(d, servers, retries=1, hedge_after_s=0.05,
                       hedge_min_s=0.02)
    try:
        ref = mono.count(EXPRS[0])["count"]
        servers[2].worker.fault = t_wire.FaultInjector(seed=5, delay=1.0,
                                                       delay_s=0.4)
        for _ in range(2):
            out = svc.count(EXPRS[0])
            assert out["count"] == ref and out["exact"]
            svc.cache.clear()
        counters = svc.stats()["counters"]
        assert counters["hedges"] >= 1 and counters["hedge_wins"] >= 1
    finally:
        svc.close()
        for s in servers:
            s.stop()


def test_remote_fault_control(cluster):
    servers, svc = cluster
    out = svc.set_fault(1, {"seed": 9, "drop": 0.5})
    assert out["ok"] and servers[1].worker.fault.seed == 9
    out = svc.set_fault(1, None)
    assert out["ok"] and servers[1].worker.fault is None


def test_rolling_reload_refreshes_changed_shard(tmp_path):
    table = _rows(2000, 11)
    idx = RSharded.build(table, shard_rows=640, k=2,
                         column_names=["a", "b", "c"])
    d = str(tmp_path / "roll")
    idx.save(d)
    servers = _servers(d, n=2)
    svc = _coordinator(d, servers)
    try:
        e = {"op": "eq", "col": "a", "value": 0}
        before = svc.count(e)["count"]
        lo, hi = int(idx.offsets[1]), int(idx.offsets[2])
        rows = table[lo:hi].copy()
        rows[:, 0] = 0
        shard = TIndex.build(rows, k=2, column_names=["a", "b", "c"],
                             cards=[idx.card(c) for c in range(3)])
        from repro_torch.core.store import write_shard_file
        write_shard_file(d, 1, shard)
        assert 1 in svc.reload_from_dir()["reloaded"]
        after = svc.count(e)
        ref = rq.QueryService(RSharded.load(d), backend="ewah")
        assert after["exact"] and after["count"] == ref.count(e)["count"]
        assert after["count"] != before
        ref.close()
        assert svc.reload_from_dir()["reloaded"] == []
        assert svc.scrub()["ok"] is True
    finally:
        svc.close()
        for s in servers:
            s.stop()


def test_cluster_http_front_end_matches_reference_coordinator(store, mono):
    """The port coordinator over port workers and the reference's over
    reference workers, each behind its own HTTP front end: the same
    answers (worker addresses and latencies aside)."""
    d = store[2]
    t_servers, r_servers = _servers(d), _servers(d, package="reference")
    t_svc = _coordinator(d, t_servers)
    r_svc = _coordinator(d, r_servers, package="reference")
    fronts = [mod.serve_in_thread(svc, max_body_bytes=64 << 10)
              for mod, svc in ((rq, r_svc), (tq, t_svc))]

    def post(port, path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(payload)
            .encode(), headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    try:
        for body in ({"select": {"count": True}, "where": EXPRS[1]},
                     {"select": {"group_count": "dim0"}, "where": EXPRS[2]},
                     {"select": {"top_k": {"col": "dim1", "k": 3}}},
                     {"query": EXPRS[3]}, {"queries": EXPRS[:2]},
                     {"sql": "SELECT count(*) FROM t WHERE dim2 = 4"},
                     {"select": {"nope": 1}}):
            outs = [post(port, "/query", body) for _, port in fronts]
            assert outs[1] == outs[0], body
        assert post(fronts[1][1], "/query", {"select": {"count": True},
                                             "where": EXPRS[1]})[1][
            "count"] == mono.count(EXPRS[1])["count"]
        for path, body in (("/admin/scrub", {}), ("/ingest",
                                                  {"rows": [[0, 0, 0]]})):
            outs = [post(port, path, body) for _, port in fronts]
            assert outs[1][0] == outs[0][0]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fronts[1][1]}/stats") as resp:
            stats = json.loads(resp.read())
        assert stats["n_shards"] == store[1].n_shards
        assert len(stats["workers"]) == 3
    finally:
        for srv, _ in fronts:
            srv.shutdown()
            srv.server_close()
        for svc, servers in ((t_svc, t_servers), (r_svc, r_servers)):
            svc.close()
            for s in servers:
                s.stop()


# -- RPC across the packages --------------------------------------------------

@pytest.mark.parametrize("direction", ["port_over_reference",
                                       "reference_over_port"])
def test_rpc_across_packages(store, mono, direction):
    """A port coordinator drives reference workers, and a reference
    coordinator drives port workers: every statement equals the mono
    answer, before and after a worker stops."""
    d = store[2]
    coordinator, workers = (("port", "reference")
                            if direction == "port_over_reference"
                            else ("reference", "port"))
    servers = _servers(d, package=workers)
    svc = _coordinator(d, servers, package=coordinator)
    try:
        for e in EXPRS:
            _statements(svc, mono, e)
        servers[0].stop()
        svc.invalidate_cache()
        for e in EXPRS:
            _statements(svc, mono, e)
        counters = svc.stats()["counters"]
        assert counters["failovers"] >= 1
        assert counters["degraded_queries"] == 0
    finally:
        svc.close()
        for s in servers:
            s.stop()


# -- spawned workers ----------------------------------------------------------

def test_local_cluster_spawns_cpu_workers(store, mono, tmp_path):
    """``LocalCluster`` spawns ``python -m repro_torch.serve.worker_api
    --device cpu`` workers: the statements through them equal the mono
    answers, before and after one is killed with SIGKILL, and a restarted
    worker is readmitted by the first health probe."""
    d = store[2]
    with t_launch.LocalCluster(d, n_workers=2, replication=2,
                               backend=BACKEND, device="cpu",
                               policy=t_cluster.Policy(**POLICY),
                               start_monitor=False, log_dir=str(tmp_path),
                               startup_timeout_s=120) as cl:
        assert all(s is not None and s > 0 for s in cl.ready_s)
        svc = cl.service
        for e in EXPRS[:2]:
            _statements(svc, mono, e)
        for _ in range(3):   # pooled sockets to worker 0
            svc.clients[0]._pool.append(svc.clients[0]._checkout())
        cl.kill_worker(0)
        svc.invalidate_cache()
        for e in EXPRS[:2]:
            _statements(svc, mono, e)
        counters = svc.stats()["counters"]
        assert counters["failovers"] >= 1
        assert counters["degraded_queries"] == 0
        cl.restart_worker(0)
        assert svc.probe_worker(0) is True
        assert svc.stats()["workers"][0]["up"] is True


def test_reference_needs_a_probe_per_stale_socket(store, tmp_path):
    """The reference's ``WorkerClient`` keeps its pooled sockets to a
    worker that died: after a restart each health probe fails on one of
    them before a fresh connection reaches the new process (ROADMAP
    Queue 3).  The port drops the pool on a failure."""
    d = store[2]
    with r_launch.LocalCluster(d, n_workers=1, replication=1,
                               backend="ewah", start_monitor=False,
                               log_dir=str(tmp_path),
                               startup_timeout_s=120) as cl:
        svc = cl.service
        svc.count(None)
        for _ in range(3):
            svc.clients[0]._pool.append(svc.clients[0]._checkout())
        cl.kill_worker(0)
        cl.restart_worker(0)
        failed = 0
        while not svc.probe_worker(0):
            failed += 1
        assert failed >= 1


def test_worker_and_cluster_entry_points_default_to_cuda(store, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    d = store[2]
    for call in (lambda: t_worker.ShardWorker(d, [0]),
                 lambda: t_worker.warm_device("cuda"),
                 lambda: t_worker.main(["--index-dir", d, "--shards", "0"]),
                 lambda: t_launch.LocalCluster(d, n_workers=1,
                                               log_dir=str(tmp_path)),
                 lambda: t_launch.main(["--index-dir", d])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert os.listdir(tmp_path) == []   # nothing was spawned
    assert t_worker.warm_device("cpu").type == "cpu"
