"""The command as the benchmark runs it: without a card, or in a checkout
that holds only the benchmark, it exits non-zero and prints no result;
on a card (``cuda``), a short traced run of the first cell is correct and
reads device time."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.run import ROOT, load_bench

ARGS = ["--workload", load_bench()["workloads"][0]["name"],
        "--seed", "4294967297", "--seconds", "1", "--trace", "0"]


def run(cwd, args=ARGS, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=str(cwd), capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_no_card_no_result(no_card):
    proc = run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_unknown_workload_no_result():
    proc = run(ROOT, ["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_short_traced_run_on_the_card(card):
    proc = run(ROOT, ARGS[:-1] + ["1"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"
