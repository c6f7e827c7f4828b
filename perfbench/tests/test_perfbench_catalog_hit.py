"""The reader of ``groupby_catalog_hit_share``: exact on a hand-made
record, None where the program bumps neither counter (a program without
run catalogs), and loaded, it reads a served index's window on the CPU:
catalogs built before the window are probed in it."""
import json
import time
import urllib.request

import numpy as np
import pytest

from perfbench.metrics import spans
from perfbench.run import HERE, load_module
from repro_torch.core import ShardedIndex
from repro_torch.kernels import _trace
from repro_torch.serve import query_api as tq

NAME = "groupby_catalog_hit_share"


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)
    monkeypatch.setattr(spans, "_live", {"cm": None, "rec": None})


def reader():
    return load_module(HERE / "metrics" / f"{NAME}.py", f"t_{NAME}")


def record(bumps):
    program = {"statements": 1, "anchor": [0, 0], "spans": [],
               "bumps": [{"name": n, "t": 0, "n": k, "request": 1}
                         for n, k in bumps]}
    return {"window_s": 1.0, "program": program,
            "records": [{"ok": True, "t_send": 0.0, "t_done": 1.0,
                         "responses": [{}]}]}


@pytest.mark.parametrize("bumps, want", [
    ([("groupby.catalog_probes", 6), ("groupby.catalog_builds", 2),
      ("groupby.catalog_probes", 2)], 80.0),
    ([("groupby.catalog_builds", 3)], 0.0),
    ([("groupby.catalog_probes", 1)], 100.0),
    ([("groupby.value_bitmaps", 30)], None),
    ([], None)])
def test_reader_on_a_record(bumps, want):
    got = reader().read(record(bumps))
    assert got == (None if want is None else pytest.approx(want))


def test_no_program_reads_none():
    rec = record([])
    del rec["program"]
    assert reader().read(rec) is None


def test_loaded_reader_on_a_served_index():
    """A warm-up statement builds column 0's catalogs on the four shards;
    in the window column 0 is probed twice a shard and column 2 built
    once a shard: 8 probes of 12."""
    rng = np.random.default_rng(9)
    table = rng.integers(0, 5, size=(4 * 1024, 3))
    index = ShardedIndex.build(table, shard_rows=1024, k=1)
    svc = tq.QueryService(index, backend="ewah", device="cpu",
                          cache_entries=0, shard_processes=0)
    srv, port = tq.serve_in_thread(svc)
    where = {"op": "in", "col": 1, "values": [0, 2, 3]}
    bodies = [{"select": {"count": True, "by": [0]}, "where": where},
              {"select": {"count": True, "by": [0]},
               "where": {"op": "eq", "col": 1, "value": 4}},
              {"select": {"count": True, "by": [0, 2]}, "where": where}]
    try:
        r = reader()
        records = []
        for body in bodies:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/query",
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req) as resp:
                records.append({"ok": True, "t_send": 0.0, "t_done": 1.0,
                                "responses": [json.loads(resp.read())]})
        deadline = time.monotonic() + 30
        while sum(s.name == "http.request" for s in list(spans.live())) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        got = r.read({"records": records[1:], "window_s": 1.0})
    finally:
        spans._finish()
        srv.shutdown()
        srv.server_close()
        svc.close()
    assert got == pytest.approx(100.0 * 8 / 12)
