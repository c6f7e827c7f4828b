"""The served shard fan-out without a shard thread pool: a ``QueryService``
forks a process pool where the fork rule picks one and otherwise runs a
statement's shards one after another in the statement's own worker thread
(on a CUDA device always, since forked workers never reach the card).
Checked on the CPU: which pool each setting gives, and that the shard tasks
of one statement run on one worker thread, in turn, parented on it."""
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core import ShardedIndex
from repro_torch.kernels import _trace
from repro_torch.serve import query_api as tq


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)


@pytest.fixture
def table():
    return np.random.default_rng(11).integers(0, 6, size=(4 * 1024, 3))


@pytest.fixture
def index(table):
    idx = ShardedIndex.build(table, shard_rows=1024, k=1)
    assert idx.n_shards == 4
    return idx


def test_no_shard_pool_but_a_forked_one(index):
    svc = tq.QueryService(index, device="cpu", shard_processes=0)
    try:
        assert svc._shard_pool is None
        svc.set_index(index)            # a swap makes the pool anew
        assert svc._shard_pool is None
        svc.shard_processes = None
        svc.device = torch.device("cuda")
        assert svc._make_shard_pool() is None
    finally:
        svc.close()


def test_a_statements_shards_run_in_turn_on_its_worker(index, table):
    svc = tq.QueryService(index, backend="ewah", device="cpu",
                          cache_entries=0, shard_processes=0)
    srv, port = tq.serve_in_thread(svc)
    body = {"select": {"count": True, "by": [0, 1]},
            "where": {"op": "in", "col": 2, "values": [1, 4]}}
    try:
        with _trace.recording() as rec:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/query",
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req) as resp:
                out = json.loads(resp.read())
            deadline = time.monotonic() + 30
            while not any(s.name == "http.request" for s in list(rec)):
                assert time.monotonic() < deadline
                time.sleep(0.01)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    want = np.zeros((6, 6), dtype=np.int64)
    keep = np.isin(table[:, 2], [1, 4])
    np.add.at(want, (table[keep, 0], table[keep, 1]), 1)
    assert out["counts"] == want.tolist()
    (st,) = [s for s in rec if s.name == "service.statement"]
    tasks = [s for s in rec if s.name == "shard.task"]
    assert sorted(s.attrs["shard"] for s in tasks) == [0, 1, 2, 3]
    assert all(s.parent == st.id for s in tasks)
    # the query worker's thread, not the HTTP handler's, and only that one
    assert len({s.thread for s in tasks}) == 1
    assert tasks[0].thread != st.thread
    spans = sorted((s.start, s.end) for s in tasks)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
