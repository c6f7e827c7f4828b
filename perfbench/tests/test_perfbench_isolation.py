"""The harness loads neither JAX nor the JAX package: a fresh interpreter
imports ``perfbench/run.py`` and drives a whole traced run through it (on
the CPU, at a tiny scale), then no module in ``sys.modules`` has the
top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole:
``repro_torch`` is the port), and none was loaded from ``benchmarks/``."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
sys.path[:0] = [ROOT, ROOT + "/src"]
import perfbench.run as harness
from perfbench.tests.tiny import tiny_run
out = tiny_run(harness.load_bench()["workloads"][-1]["name"], trace=True)
bench = [m.__file__ for m in list(sys.modules.values())
         if (getattr(m, "__file__", None) or "").startswith(
             ROOT + "/benchmarks")]
print(json.dumps({"found": harness.forbidden_modules(),
                  "top": sorted({n.split(".")[0] for n in sys.modules}),
                  "benchmarks": bench, "correct": out["correct"]}))
"""


def test_nothing_of_jax_or_the_jax_package_is_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["found"] == []
    assert "repro_torch" in out["top"] and "perfbench" in out["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["top"])
    assert out["benchmarks"] == []


def test_forbidden_names_compare_whole(monkeypatch):
    from perfbench import run as harness
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]
