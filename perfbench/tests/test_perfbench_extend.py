"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell with new files and new entries only: in a temporary copy of
the benchmark, a throwaway mix, a throwaway metric, a config at
another scale and a cell pairing them run without an edit to any file
the benchmark had."""
import hashlib
import json
import shutil

from perfbench.run import ROOT, load_bench
from perfbench.tests.tiny import tiny_run


CONFIG = load_bench()["configs"][0]["name"]


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)

    pb = tmp_path / "perfbench"
    (pb / "traffic" / "throwaway.json").write_text(json.dumps({
        "clients": 2, "max_queries": 400,
        "templates": {"q2.1": 2, "q1.1": 1}}))
    (pb / "metrics" / "statements_per_query.py").write_text(
        "def read(rec):\n"
        "    done = [r for r in rec['records'] if r['ok']]\n"
        "    return sum(len(r['responses']) for r in done) / len(done)\n")
    conf = json.loads((pb / "configs" / f"{CONFIG}.json").read_text())
    conf.update(name="ssb-sf2-lex", scale_factor=2, sort="lex")
    (pb / "configs" / "ssb-sf2-lex.json").write_text(json.dumps(conf))

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "ssb-sf2-lex", "source": "throwaway",
        "file": "perfbench/configs/ssb-sf2-lex.json", "reduced": [],
        "why": "throwaway"})
    bench["workloads"].append({
        "name": "ssb-sf2-lex.throwaway", "config": "ssb-sf2-lex",
        "traffic": "throwaway", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({
        "name": "statements_per_query", "unit": "statements/query",
        "better": "lower", "source": "program_counter", "layer": "client",
        "moves": "queries_per_s", "workloads": ["ssb-sf2-lex.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = "ssb-sf2-lex.throwaway"
    traced = tiny_run(cell, trace=True, root=tmp_path)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["statements_per_query"]["value"] >= 1.0
    assert "logical_reduce_roofline" not in traced["metrics"]
    timed = tiny_run(cell, trace=False, root=tmp_path)
    assert timed["correct"]
    assert set(timed["metrics"]) == {e["name"] for e in bench["end_to_end"]
                                     if "workloads" not in e}
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
