"""The index build's spans and counters (``Dataset.from_rows``, with
``kernels._trace``) on the CPU: under ``recording()`` a sorted, sharded
build emits each of its four steps' spans inside the timed call, with the
rows each handled, and none while spans are off; the word counters add up
to the words of the run-list bitmaps the build emits, and leave out the
container-backed ones; and on a tiny Star Schema Benchmark table sorted
lexicographically the port answers the benchmark's statements as the
reference package does."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import dataset as r_dataset
from repro_torch.core import dataset as t_dataset
from repro_torch.kernels import _trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.gen import ssb, traffic  # noqa: E402

STEPS = ("build.sort", "build.encode", "build.index", "build.shard")
WORDS = ("index.words.literal", "index.words.fill")
SEED = 2900000011


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)


@pytest.fixture(scope="module")
def table():
    return ssb.generate(SEED, 0.002)


def build(D, table, sort, **kw):
    return D.Dataset.from_rows(
        table["rows"], ssb.COLUMNS, sort=sort, k=1,
        cards=[ssb.CARDS[c] for c in ssb.COLUMNS], shards=4,
        measures=table["measures"], **kw)


def bitmaps(ds):
    return [bm for sh in ds.index.shards for col in sh.columns
            for part in col.bitmaps for bm in part]


def test_four_build_spans_inside_the_timed_build(table):
    n = len(table["rows"])
    with _trace.recording() as rec:
        t0 = time.perf_counter_ns()
        build(t_dataset, table, "lex", device="cpu")
        t1 = time.perf_counter_ns()
    names = [s.name for s in rec]
    assert set(names) == set(STEPS)
    assert names.count("build.shard") == 1
    # the column order, then the merge and the permutation
    assert names.count("build.sort") == 2
    # one encode and one index span a column of each of the 4 shards
    assert names.count("build.encode") == names.count("build.index") \
        == 4 * len(ssb.COLUMNS)
    assert all(t0 <= s.start <= s.end <= t1 for s in rec)
    for s in rec:
        if s.name in ("build.sort", "build.shard"):
            assert s.parent is None and s.attrs["rows"] == n
        else:
            assert s.attrs["rows"] > 0
    shard = next(s for s in rec if s.name == "build.shard")
    cut = [s for s in rec if s.name in ("build.encode", "build.index")]
    assert all(s.parent == shard.id == s.request for s in cut)
    assert sum(s.attrs["rows"] for s in cut
               if s.name == "build.index" and s.attrs["col"] == 0) == n


def test_no_build_span_while_spans_are_off(table, monkeypatch):
    made = []

    class Counted(_trace._Span):
        __slots__ = ()

        def __init__(self, name, attrs):
            made.append(name)
            super().__init__(name, attrs)

    monkeypatch.setattr(_trace, "_Span", Counted)
    build(t_dataset, table, "lex", device="cpu")
    assert made == []
    with _trace.recording():
        build(t_dataset, table, "lex", device="cpu")
    assert set(made) == set(STEPS)


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_word_counters_add_up_to_the_bitmaps(table, sort):
    before = _trace.counter_values()
    ds = build(t_dataset, table, sort, device="cpu")
    after = _trace.counter_values()
    got = {k: after.get(k, 0) - before.get(k, 0) for k in WORDS}
    bms = bitmaps(ds)
    runs = [bm for bm in bms if bm._cont is None]
    assert got["index.words.literal"] == sum(len(bm.runlist().lits)
                                             for bm in runs)
    assert got["index.words.literal"] + got["index.words.fill"] == \
        sum(bm.size_words for bm in runs)
    if sort == "lex":
        # a sorted build is run-list through and through
        assert len(runs) == len(bms)
        assert sum(got.values()) == ds.index.size_words
    else:
        # container-backed bitmaps are not counted
        assert len(runs) < len(bms)
        assert sum(got.values()) < ds.index.size_words


def test_sorted_ssb_answers_equal_the_reference(table):
    mine = build(t_dataset, table, "lex", device="cpu")
    ref = build(r_dataset, table, "lex")
    assert mine.sort_order == ref.sort_order
    assert [bm.size_words for bm in bitmaps(mine)] == \
        [bm.size_words for bm in bitmaps(ref)]
    mix = traffic.load_mix(ROOT / "perfbench" / "traffic"
                           / "flights-x8.json")
    # one draw of each template, and a deck's repeated draws of Q3.1
    queries = traffic.sequence(mix, SEED)[:traffic.deck_size(mix)]
    picked = queries[::8] + queries[48:56]
    t_svc, r_svc = mine.serve(), ref.serve()
    try:
        for q in picked:
            for st in q["statements"]:
                assert t_svc.statement(st) == r_svc.statement(st), st
    finally:
        t_svc.close()
        r_svc.close()
    assert np.array_equal(mine.row_perm, ref.row_perm)
