"""The readers of the program's spans and counters
(``perfbench/metrics/spans.py`` and the five metrics on it): exact values
on a hand-made record, None where there is nothing to read; loaded, they
record a tiny served index's statements on the CPU and read them; and
``trace_gaps``' gap names and clock check on a hand-made trace."""
import json
import time
import urllib.request

import numpy as np
import pytest

from perfbench import trace_gaps
from perfbench.metrics import spans
from perfbench.run import HERE, load_module
from repro_torch.core import ShardedIndex
from repro_torch.kernels import _trace
from repro_torch.serve import query_api as tq

NEW = ("groupby_catalog_share", "groupby_useful_bitmap_share",
       "kernel_node_ms", "shard_parallelism", "http_json_share")
MS = 1_000_000


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)
    monkeypatch.setattr(spans, "_live", {"cm": None, "rec": None})


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"t_{name}")


def span(name, start_ms, end_ms, id, parent=None, request=1, **attrs):
    return {"name": name, "start": start_ms * MS, "end": end_ms * MS,
            "thread": 0, "id": id, "parent": parent, "request": request,
            "attrs": attrs}


def bump(name, n, request=1):
    return {"name": name, "t": 0, "n": n, "request": request}


def record(program, **kw):
    rec = {"window_s": 2.0, "program": program,
           "records": [{"ok": True, "t_send": 0.0, "t_done": 1.0,
                        "responses": [{}, {}]},
                       {"ok": True, "t_send": 1.0, "t_done": 1.5,
                        "responses": [{}]}]}
    rec.update(kw)
    return rec


PROGRAM = {
    "statements": 3, "anchor": [0, 0],
    "spans": [span("groupby.catalog", 0, 300, 1),
              span("groupby.catalog", 200, 500, 2),
              span("groupby.catalog", 1000, 1100, 3),
              span("shard.task", 0, 100, 4),
              span("shard.task", 50, 150, 5),
              span("shard.task", 150, 200, 6),
              span("exec.kernel_node", 0, 4, 7),
              span("exec.kernel_node", 10, 12, 8)],
    "bumps": [bump("groupby.value_bitmaps", 30),
              bump("groupby.value_bitmaps_met", 3),
              bump("groupby.value_bitmaps", 10),
              bump("groupby.value_bitmaps_met", 1),
              bump("statements/sum.by2/n", 2),
              bump("statements/sum.by2/seconds", 0.9),
              bump("statements/count/seconds", 0.3)]}


def test_readers_on_a_record():
    rec = record(PROGRAM)
    got = {name: reader(name).read(rec) for name in NEW}
    assert got["groupby_catalog_share"] == pytest.approx(100 * 0.6 / 2.0)
    assert got["groupby_useful_bitmap_share"] == pytest.approx(10.0)
    assert got["kernel_node_ms"] == pytest.approx(3.0)
    assert got["shard_parallelism"] == pytest.approx(0.25 / 0.2)
    assert got["http_json_share"] == pytest.approx(100 * (1 - 1.2 / 1.5))


def test_readers_find_nothing():
    for program in (None, dict(PROGRAM, spans=[], bumps=[])):
        for name in NEW:
            assert reader(name).read(record(program)) is None, name
    idle = record(PROGRAM, records=[], window_s=0.0)
    assert reader("groupby_catalog_share").read(idle) is None
    assert reader("http_json_share").read(idle) is None


def test_loaded_readers_record_a_served_index(capsys):
    rng = np.random.default_rng(9)
    table = rng.integers(0, 5, size=(4 * 1024, 3))
    index = ShardedIndex.build(table, shard_rows=1024, k=1)
    svc = tq.QueryService(index, backend="kernel", device="cpu",
                          cache_entries=0, shard_processes=0)
    srv, port = tq.serve_in_thread(svc)
    bodies = [{"select": {"count": True}},      # warm-up: not the window's
              {"select": {"count": True, "by": [0]},
               "where": {"op": "in", "col": 1, "values": [0, 2, 3]}},
              {"select": {"group_count": 2},
               "where": {"op": "eq", "col": 0, "value": 4}}]
    try:
        readers = {name: reader(name) for name in NEW}
        assert spans.live() is not None
        records = []
        for body in bodies:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/query",
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req) as resp:
                records.append({"ok": True, "t_send": 0.0, "t_done": 1.0,
                                "responses": [json.loads(resp.read())]})
        # each handler closes its span after the client has its answer
        deadline = time.monotonic() + 30
        while sum(s.name == "http.request" for s in list(spans.live())) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        rec = {"records": records[1:], "window_s": 1.0}
        got = {name: r.read(rec) for name, r in readers.items()}
    finally:
        spans._finish()
        srv.shutdown()
        srv.server_close()
        svc.close()
    assert spans.live() is None and not _trace._on
    assert rec["program"]["statements"] == 2
    assert len({s["request"] for s in rec["program"]["spans"]}) == 2
    assert all(v is not None for v in got.values()), got
    # on 4,096 uniform rows every value of a column meets these filters
    assert got["groupby_useful_bitmap_share"] == 100.0
    assert 0 < got["groupby_catalog_share"] < 100
    assert 1.0 <= got["shard_parallelism"] <= 4.0
    assert got["kernel_node_ms"] > 0
    err = capsys.readouterr().err
    assert "span service.statement: calls 2," in err
    assert "spans per statement:" in err


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(_trace, "recording")
    readers = {name: reader(name) for name in NEW}
    assert spans.live() is None
    rec = record(None)
    del rec["program"]
    assert all(r.read(rec) is None for r in readers.values())


def test_gap_names_and_clock_check():
    base = 5_000_000_000
    clock = trace_gaps.Clock((base + 1_000 * MS, 7 * MS), base)
    # perf 7 ms is trace second 1.0

    thread = 0x7F00_8000_0009  # its low 32 bits, read signed: 9 - 2**31

    def S(name, a, b, id, parent=None, request=1, **attrs):
        return _trace.Span(name, int(7 * MS + a * MS), int(7 * MS + b * MS),
                           thread, id, parent, request, attrs)
    program = [S("service.statement", 0, 100, 2, 1, kind="sum.by2"),
               S("groupby.catalog", 10, 60, 3, 2),
               S("exec.kernel_node", 60, 80, 4, 2),
               S("kernel.launch", 62, 63, 5, 4),
               S("ewah.from_words", 70, 80, 6, 4),
               S("kernel.download", 64, 65, 7, 4),
               S("kernel.download", 90, 91, 8, 2)]
    gaps = [(1.0, 1.05), (1.065, 1.08)]
    assert trace_gaps.name_gaps(gaps, program, clock) == [
        ["statement.sum.by2/groupby.catalog", pytest.approx(0.05)],
        ["statement.sum.by2/ewah.from_words", pytest.approx(0.015)]]

    def ev(cat, name, t, corr, tid=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": 1e6 * t,
                "dur": 5, "tid": tid, "args": {"correlation": corr}}
    # the copies' runtime calls put the trace's host clock 2 ms ahead of
    # the spans': fitted, the first kernel starts before its launch
    tid = 9 - 2 ** 31
    events = [ev("kernel", "logical_reduce_kernel", 1.0625, 1),
              ev("cuda_runtime", "cudaLaunchKernel", 1.0622, 1, tid),
              ev("kernel", "logical_reduce_kernel", 1.0900, 2),
              ev("gpu_memcpy", "Memcpy DtoH", 1.067, 3),
              ev("cuda_runtime", "cudaMemcpyAsync", 1.066, 3, tid),
              ev("gpu_memcpy", "Memcpy DtoH", 1.093, 4),
              ev("cuda_runtime", "cudaMemcpyAsync", 1.092, 4, 2 ** 31 + 9)]
    check = trace_gaps.clock_check(events, program, clock, (1.0, 1.1))
    assert check["kernels"] == 2 and check["launch_spans"] == 1
    assert check["share_inside"] == 0.5
    assert check["max_miss_ms"] == pytest.approx(10.0)
    assert check["misses"] == [[pytest.approx(0.0275), pytest.approx(10.0)]]
    # only the first kernel's runtime call is in the trace
    assert check["own"] == {"matched": 0.5, "share_inside": 1.0,
                            "max_launch_to_kernel_ms": pytest.approx(0.5)}
    assert check["drift"]["pairs"] == 2
    assert check["drift"]["offset_ms"] == pytest.approx(2.0)
    assert check["drift"]["ppm"] == pytest.approx(0.0, abs=1e-3)
    assert check["share_inside_fitted"] == 0.0
    assert check["max_miss_ms_fitted"] == pytest.approx(8.0)
    moved = clock.fitted([(7 * MS, 1.001), (7 * MS + 1000 * MS, 2.002)], 1.0)
    assert moved.trace_s(7 * MS + 500 * MS) == pytest.approx(1.5015)
    assert moved.perf_ns(1.5015) == 7 * MS + 500 * MS
