"""The sorted cell, ``ssb-sf1-lex.flights-x8``, on the CPU at a tiny
scale: a run is correct with every answer of its one 104-query deck
judged against the plain reference; the sorted store is run-list through
and through, its words those the build's counters add up; and the build's
two readers (``build_sort_share``, ``index_literal_word_share``) read
exact values from a hand-made record, numbers from a traced run, and None
where the program recorded no build."""
import json

import pytest

from perfbench.gen import ssb, traffic
from perfbench.metrics import build_spans, spans
from perfbench.run import HERE, ROOT, load_bench, load_module
from perfbench.tests.tiny import SCALE, tiny_run
from repro_torch.core import Dataset
from repro_torch.kernels import _trace
from repro_torch.serve.query_api import QueryService

CELL = "ssb-sf1-lex.flights-x8"
SEED = 3100000007
READERS = ("build_sort_share", "index_literal_word_share")
BENCH = load_bench()
ENTRY = next(w for w in BENCH["workloads"] if w["name"] == CELL)
MIX = traffic.load_mix(HERE / "traffic" / f"{ENTRY['traffic']}.json")


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)
    monkeypatch.setattr(spans, "_live", {"cm": None, "rec": None})
    monkeypatch.setattr(build_spans, "_held", {"rec": None})


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"t_{name}")


def test_the_cell_is_one_sorted_deployment_and_an_eight_draw_deck():
    conf_entry = next(c for c in BENCH["configs"]
                      if c["name"] == ENTRY["config"])
    conf = json.loads((ROOT / conf_entry["file"]).read_text())
    arrival = json.loads(
        (HERE / "configs" / "ssb-sf1-arrival.json").read_text())
    same = ("generator", "scale_factor", "columns", "cards", "measures",
            "k", "shards", "service", "guarantees")
    assert {k: conf[k] for k in same} == {k: arrival[k] for k in same}
    assert conf["sort"] == "lex" and "container" not in conf
    assert ENTRY["chips"] == 1 and conf_entry["reduced"] == []
    flights = traffic.load_mix(HERE / "traffic" / "flights.json")
    assert list(MIX["templates"]) == list(flights["templates"])
    assert set(MIX["templates"].values()) == {8}
    assert traffic.deck_size(MIX) == 104


def test_a_tiny_run_judges_its_whole_deck():
    out = tiny_run(CELL, seed=SEED)
    assert out["correct"], out["checks"]
    assert out["attempted"] == traffic.deck_size(MIX)
    deck = traffic.sequence(MIX, SEED)[:traffic.deck_size(MIX)]
    assert out["checks"]["answers_judged"]["value"] == \
        sum(len(q["statements"]) for q in deck)
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}


def test_a_traced_tiny_run_reads_the_build():
    out = tiny_run(CELL, seed=SEED, trace=True)
    assert out["correct"], out["checks"]
    for name in READERS:
        assert 0.0 < out["metrics"][name]["value"] < 100.0, name
    # the deck repeats draws of templates with few parameter sets
    assert out["metrics"]["result_cache_hit_share"]["value"] > 0.0
    assert spans.live() is None and not _trace._on


def test_the_sorted_store_is_run_list_and_its_words_are_counted(tmp_path):
    table = ssb.generate(SEED, SCALE)
    before = _trace.counter_values()
    ds = Dataset.from_rows(
        table["rows"], ssb.COLUMNS, sort="lex", k=1,
        cards=[ssb.CARDS[c] for c in ssb.COLUMNS], shards=4,
        measures=table["measures"], device="cpu")
    after = _trace.counter_values()
    ds.save(str(tmp_path / "store"))
    svc = QueryService.from_dir(str(tmp_path / "store"), mmap=True,
                                device="cpu", shard_processes=0)
    try:
        bms = [bm for sh in svc.index.shards for col in sh.columns
               for part in col.bitmaps for bm in part]
        size_words = svc.stats()["size_words"]
    finally:
        svc.close()
    assert bms and all(bm._cont is None for bm in bms)

    def grew(name):
        return after.get(name, 0) - before.get(name, 0)
    assert grew("index.words.literal") + grew("index.words.fill") == \
        size_words


def build_record(sort_s, other_s, literal, fill):
    return {"program": None, "build": {
        "seconds": {"build.sort": sort_s, "build.encode": other_s,
                    "build.index": 2 * other_s, "build.shard": 0.0},
        "counts": {"index.words.literal": literal,
                   "index.words.fill": fill, "other.counter": 1000}}}


def test_readers_on_a_record():
    rec = build_record(6.0, 1.0, 3, 1)
    assert reader("build_sort_share").read(rec) == pytest.approx(
        100 * 6 / 9)
    assert reader("index_literal_word_share").read(rec) == 75.0
    for name in READERS:
        assert reader(name).read({"program": None, "build": None}) is None
    idle = build_record(0.0, 0.0, 0, 0)
    assert reader("build_sort_share").read(idle) is None
    assert reader("index_literal_word_share").read(idle) is None


def test_loaded_readers_read_a_build_and_nothing_else():
    table = ssb.generate(SEED, SCALE)
    readers = {name: reader(name) for name in READERS}
    assert spans.live() is not None
    with _trace.span("http.request"):
        _trace.count("index.words.literal", 10 ** 9)   # not the build's
    Dataset.from_rows(table["rows"], ssb.COLUMNS, sort="lex",
                      cards=[ssb.CARDS[c] for c in ssb.COLUMNS], shards=4,
                      device="cpu")
    rec = {"records": []}
    got = {name: r.read(rec) for name, r in readers.items()}
    assert spans.live() is None and not _trace._on
    assert all(0.0 < v < 100.0 for v in got.values()), got
    assert set(rec["build"]["seconds"]) == set(build_spans.STEPS)
    assert rec["build"]["counts"]["index.words.literal"] < 10 ** 9


def test_a_program_without_build_spans_reads_none(monkeypatch):
    readers = {name: reader(name) for name in READERS}
    with _trace.span("http.request"):
        pass
    rec = {"records": []}
    assert all(r.read(rec) is None for r in readers.values())
    monkeypatch.delattr(_trace, "recording")
    readers = {name: reader(name) for name in READERS}
    assert spans.live() is None
    assert all(r.read({"records": []}) is None for r in readers.values())
