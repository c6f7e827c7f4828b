"""The port's spans and counters (``repro_torch.kernels._trace``) on the
served query path, on the CPU: off, a span is the shared null context and
nothing is kept; on, one statement over HTTP on a 4-shard index gives one
request, shard tasks parented on the statement across the pool and self
times that are never negative; a span lands inside the profiler's window
annotation on the trace's clock; and the counters read through ``/stats``
are exact on a hand-built index."""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core import BitmapIndex, ShardedIndex
from repro_torch.kernels import _trace
from repro_torch.serve import query_api as tq


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    """Each test starts with spans off, whatever another test of the
    process left on."""
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)


def _http(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def _until_requests(rec, n, timeout=30.0):
    """Wait until ``rec`` holds ``n`` ``http.request`` spans: the handler
    closes its span after the response is written, so after the client
    has read it."""
    deadline = time.monotonic() + timeout
    while sum(s.name == "http.request" for s in list(rec)) < n:
        assert time.monotonic() < deadline, "the request span never closed"
        time.sleep(0.01)


def _served(index, backend="ewah", **kw):
    svc = tq.QueryService(index, backend=backend, device="cpu",
                          cache_entries=0, shard_processes=0, **kw)
    srv, port = tq.serve_in_thread(svc)
    return svc, srv, port


def _close(svc, srv):
    srv.shutdown()
    srv.server_close()
    svc.close()


def test_spans_off_record_nothing():
    assert _trace.span("exec.plan") is _trace._NULL
    assert _trace.span("shard.task", shard=3) is _trace._NULL
    fn = len
    assert _trace.carry(fn) is fn
    with _trace.span("http.request"):
        assert _trace._stack() == []
        with _trace.recording() as rec:
            pass                    # opened while off: never recorded
    assert list(rec) == [] and rec.bumps == []
    assert _trace.span("exec.plan") is _trace._NULL


def test_one_statement_is_one_request_across_the_pools():
    rng = np.random.default_rng(4)
    table = rng.integers(0, 6, size=(4 * 1024, 3))
    index = ShardedIndex.build(table, shard_rows=1024, k=1)
    assert index.n_shards == 4
    svc, srv, port = _served(index)
    body = {"select": {"count": True, "by": [0, 1]},
            "where": {"op": "in", "col": 2, "values": [1, 4]}}
    try:
        with _trace.recording() as rec:
            out = _http(port, "/query", body)
            _until_requests(rec, 1)
        stats = _http(port, "/stats")
    finally:
        _close(svc, srv)
    want = np.zeros((6, 6), dtype=np.int64)
    keep = np.isin(table[:, 2], [1, 4])
    np.add.at(want, (table[keep, 0], table[keep, 1]), 1)
    assert out["counts"] == want.tolist()
    (root,) = [s for s in rec if s.name == "http.request"]
    assert {s.request for s in rec} == {root.id}
    (st,) = [s for s in rec if s.name == "service.statement"]
    assert st.parent == root.id and st.attrs == {"kind": "count.by2"}
    tasks = [s for s in rec if s.name == "shard.task"]
    assert sorted(s.attrs["shard"] for s in tasks) == [0, 1, 2, 3]
    assert all(s.parent == st.id for s in tasks)
    assert all(s.thread != st.thread for s in tasks)
    by_id = {s.id: s for s in rec}
    for s in rec:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end
    names = {s.name for s in rec}
    assert {"exec.plan", "exec.filter", "groupby.catalog",
            "groupby.cells"} <= names
    selfs = _trace.self_ns(rec)
    assert set(selfs) == set(by_id)
    assert all(v >= 0 for v in selfs.values())
    assert selfs[root.id] <= root.end - root.start
    assert stats["statements"]["count.by2"]["n"] >= 1
    assert stats["statements"]["count.by2"]["seconds"] > 0


def test_a_span_falls_inside_the_profilers_window(tmp_path):
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _trace.recording() as rec:
            with torch.profiler.record_function("perfbench.window"):
                time.sleep(0.005)
                with _trace.span("exec.plan"):
                    time.sleep(0.005)
                time.sleep(0.005)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1000
    (win,) = [ev for ev in trace["traceEvents"]
              if ev.get("name") == "perfbench.window" and ev.get("ph") == "X"]
    (s,) = rec
    wall, perf = rec.anchor
    start = (wall + s.start - perf) / 1000 - base_us
    end = (wall + s.end - perf) / 1000 - base_us
    assert win["ts"] < start < end < win["ts"] + win["dur"]


@pytest.mark.parametrize("backend", ["ewah", "kernel"])
def test_counters_are_exact_through_stats(backend):
    # column 0 takes 0-3, column 1 takes 0-2; where a == 1, b is 0 or 2
    a = np.repeat(np.arange(4), 64)
    b = np.arange(256) % 3
    b[a == 1] = np.arange(64) % 2 * 2
    index = BitmapIndex.build(np.stack([a, b], axis=1), k=1)
    svc, srv, port = _served(index, backend, pool_workers=1)
    try:
        before = _http(port, "/stats")["counters"]
        out = _http(port, "/query", {
            "select": {"group_count": 1},
            "where": {"op": "eq", "col": 0, "value": 1}})
        assert out["counts"] == [32, 0, 32]
        mid = _http(port, "/stats")["counters"]
        # one batch on one worker: the shared OR is worked out once and
        # found once; each statement's root misses the operand cache
        either = {"op": "or", "args": [{"op": "eq", "col": 0, "value": 1},
                                       {"op": "eq", "col": 0, "value": 2}]}
        _http(port, "/query", {"queries": [
            {"op": "and", "args": [either, {"op": "eq", "col": 1,
                                            "value": v}]}
            for v in (0, 1)]})
        after = _http(port, "/stats")["counters"]
    finally:
        _close(svc, srv)

    def delta(x, y, name):
        return y.get(name, 0) - x.get(name, 0)
    assert delta(before, mid, "groupby.value_bitmaps") == 3
    assert delta(before, mid, "groupby.value_bitmaps_met") == 2
    assert delta(mid, after, "executor.sub_hits") == 1
    assert delta(mid, after, "executor.sub_misses") == 3
    nodes = {"ewah": 0, "kernel": 0}
    nodes[backend] = 3
    assert delta(mid, after, "executor.nodes_ewah") == nodes["ewah"]
    assert delta(mid, after, "executor.nodes_kernel") == nodes["kernel"]


def test_counts_are_kept_with_their_request_while_recording():
    with _trace.recording() as rec:
        with _trace.span("service.statement") as st:
            _trace.count("groupby.value_bitmaps", 5)
            t = threading.Thread(target=_trace.carry(
                lambda: _trace.count("executor.sub_hits")))
            t.start()
            t.join()
        _trace.count("executor.sub_misses")
    assert [(b.name, b.n, b.request) for b in rec.bumps] == [
        ("groupby.value_bitmaps", 5, st.id),
        ("executor.sub_hits", 1, st.id),
        ("executor.sub_misses", 1, None)]
