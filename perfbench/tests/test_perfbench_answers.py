"""At a tiny scale on the CPU, the service's answer to every template of
the mix equals the plain reference's, on a sorted and a load-order build;
and the reference's comparison rejects an answer that is off by one."""
import json

import pytest

from perfbench.client import post
from perfbench.gen import ssb, traffic
from perfbench.reference.answers import Reference
from perfbench.run import HERE
from repro_torch.core import Dataset
from repro_torch.serve.query_api import QueryService, serve_in_thread

SEED = 987654321012
SCALE = 0.002


@pytest.fixture(scope="module")
def table():
    return ssb.generate(SEED, SCALE)


@pytest.fixture(scope="module")
def reference(table):
    return Reference(table["rows"], ssb.COLUMNS, ssb.CARDS,
                     table["measures"], device="cpu")


def served(table, sort, tmp_path):
    ds = Dataset.from_rows(
        table["rows"], ssb.COLUMNS, sort=sort, k=1,
        cards=[ssb.CARDS[c] for c in ssb.COLUMNS], shards=4,
        measures=table["measures"], device="cpu")
    ds.save(str(tmp_path / sort))
    return QueryService.from_dir(str(tmp_path / sort), mmap=True,
                                 device="cpu", backend="auto",
                                 pool_workers=4, shard_processes=0)


def statements(n):
    mix = traffic.load_mix(HERE / "traffic" / "flights.json")
    return [st for q in traffic.sequence(mix, SEED)[:n]
            for st in q["statements"]]


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_every_template_matches_the_reference(table, reference, sort,
                                              tmp_path):
    svc = served(table, sort, tmp_path)
    try:
        sts = statements(26)
        for st in sts:
            assert reference.judge(st, svc.statement(st)), st
        # and over HTTP, as the window sends them
        srv, port = serve_in_thread(svc)
        try:
            for st in sts[:13]:
                status, resp = post(port, json.dumps(st).encode(), 60)
                assert status == 200 and reference.judge(st, resp), st
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        svc.close()


def test_judge_rejects_a_wrong_answer(table, reference):
    st = statements(13)
    group = next(s for s in st if s["select"].get("by")
                 and any(reference.answer(s)[1]))
    scalar = next(s for s in st if not s["select"].get("by"))
    want = reference.answer(group)
    resp = {"counts": want[1], "values": list(want[2])}
    assert reference.judge(group, resp)
    i = next(i for i, c in enumerate(want[1]) if c)
    resp["values"][i] += 1
    assert not reference.judge(group, resp)
    kind, value, count = reference.answer(scalar)
    assert reference.judge(scalar, {"value": value, "count": count})
    assert not reference.judge(scalar, {"value": value - 1, "count": count})
    assert not reference.judge(scalar, None)

