"""The smoke's examples phase (``chip_smoke.examples_phase``) on the CPU,
with ``DEVICE = "cpu"`` and ``EXAMPLES_FULL = False`` (small tables, 2
training steps, 4 new tokens), in a fresh interpreter: its quickstart
forks shard workers and its cluster example spawns them.  Every example
must pass its checks; on the CPU no kernel launches (the wrappers run
their plain versions)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PHASE = r"""
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as smoke
from repro_torch.kernels import (bitpack_kernel, grad_compress,
                                 logical_reduce, popcount, word_logical)
smoke.DEVICE, smoke.EXAMPLES_FULL = "cpu", False
out = smoke.examples_phase(torch, (word_logical, logical_reduce,
                                   grad_compress, popcount, bitpack_kernel))
print(json.dumps({"examples": [l["example"] for l in out["lines"]],
                  "launches": out["launches"],
                  "words": out["lines"][0]["words"]}))
"""


def test_smoke_examples_phase_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", PHASE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["examples"] == ["torch_sort_study", "torch_quickstart",
                               "torch_serve_lm", "torch_train_lm",
                               "torch_cluster_quickstart"]
    assert not any(out["launches"].values())
    assert list(out["words"]) == ["random-shuffle", "random-sort",
                                  "block-sort(10)", "lex", "gray"]
    assert "example torch_quickstart| compacted -> epoch 1" in res.stdout
