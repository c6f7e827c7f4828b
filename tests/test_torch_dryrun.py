"""The port's dry-run CLI, sweep and breakdown on meta (no card), and the
smoke's dry-run phase on the CPU at a reduced size."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.configs import shape_applicable as r_shape_applicable
from repro_torch.configs import ARCHS
from repro_torch.launch import breakdown, dryrun, sweep


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
# the reference's record keys (repro.launch.dryrun.run_cell), with the
# counter's totals under "ops" where it has "hlo" and no XLA cost analysis
REF_KEYS = {"arch", "shape", "mesh", "kind", "tag", "status", "n_devices",
            "mesh_shape", "memory_analysis", "xla_cost_analysis", "hlo",
            "link_bytes", "seconds"}


def test_dryrun_subprocess_multi_pod(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "multi",
           "--out-dir", str(tmp_path), "--tag", "pytest"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__multi__pytest.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["ops"]["flops"] > 0 and rec["ops"]["split"] == "even_split"
    assert set(rec) == REF_KEYS - {"xla_cost_analysis", "hlo"} | {"ops"}
    assert {"flops", "bytes", "collectives", "collective_counts"} <= \
        set(rec["ops"])
    assert rec["link_bytes"] == 0.0
    mem = rec["memory_analysis"]
    g = rec["ops"]["global"]
    assert mem["temp_size_in_bytes"] == g["peak_bytes"] - g["argument_bytes"]
    # the KV cache is 51.5 GB; per device a 512th of it and of the weights
    assert 51.5e9 < g["argument_bytes"] < 54e9
    assert 0 < mem["argument_size_in_bytes"] < g["argument_bytes"] / 256
    assert rec["ops"]["flops"] * 512 == pytest.approx(g["flops"])


@pytest.mark.parametrize("arch", sorted(
    a for a, cfg in ARCHS.items() if not cfg.sub_quadratic))
def test_skipped_where_the_reference_skips(arch):
    """long_500k for the eight archs without sub-quadratic attention (the
    sweep in the smoke's phase runs it for the other two)."""
    args = SimpleNamespace(tag="baseline")
    rec = dryrun.run_cell(arch, "long_500k", "single", args)
    ok, why = r_shape_applicable(r_get_config(arch), R_SHAPES["long_500k"])
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == why


def test_second_sweep_runs_nothing(tmp_path, capsys):
    argv = ["--mesh", "single", "--out-dir", str(tmp_path), "--only-arch",
            "qwen2-0.5b"]
    sweep.main(argv)
    first = capsys.readouterr().out
    assert "COMPLETE done=4 failed=0 cached=0" in first
    assert len(list(tmp_path.glob("*.json"))) == 4
    sweep.main(argv)
    second = capsys.readouterr().out
    assert "COMPLETE done=0 failed=0 cached=4" in second
    assert "[dryrun]" not in second


def test_breakdown_ranks_ops(capsys):
    breakdown.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                    "--top", "4"])
    out = capsys.readouterr().out
    assert "==== TOP BYTES ====" in out and "==== TOP FLOPS ====" in out
    flops = out.split("==== TOP FLOPS ====")[1].strip().splitlines()
    assert len(flops) == 4 and " bmm " in flops[0]
    assert "models.attention._sdpa" in flops[0]


def test_smoke_dryrun_phase_on_cpu(monkeypatch):
    """The smoke's dry-run phase with DEVICE = "cpu": the sweep (one arch),
    the three steps at reduced size counted on meta and on the CPU (equal
    outside the kernel wrappers, whose plain versions the CPU runs), and
    the three remat policies' losses."""
    from repro_torch.kernels import bitpack_kernel, grad_compress, \
        logical_reduce, popcount, word_logical
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    monkeypatch.setattr(smoke, "DRYRUN_FULL", False)
    monkeypatch.setattr(smoke, "DRYRUN_ARCHS", ["qwen2-0.5b"])
    out = smoke.dryrun_phase(torch, (word_logical, logical_reduce,
                                     grad_compress, popcount,
                                     bitpack_kernel))
    assert [s["label"] for s in out["steps"]] == [
        "qwen2-0.5b decode_32k", "mamba2-780m decode_32k",
        "qwen2-0.5b compressed train 8x128"]
    assert out["steps"][2]["block_sqnorms"]["where"] == \
        "kernels.grad_compress._launch"
    assert set(out["remat"]) == {"full", "dots_nb", "none"}
    assert not any(out["launches"].values())


def test_tooling_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.configs.input_specs\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.launch.mesh, repro_torch.launch.op_analysis\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.breakdown\n"
        "import repro_torch.launch.sweep\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_knobs_reach_the_trace():
    """The reference's knobs: bfloat16 parameters and moments shrink the
    per-device arguments, two microbatches and ``dots_nb`` change the
    count, the bfloat16-score switch is off again after the cell."""
    from repro_torch.distributed import sharding
    base = SimpleNamespace(tag="baseline")
    knobs = SimpleNamespace(tag="knobs", param_dtype="bf16", opt_dtype="bf16",
                            microbatches=2, variant="opt", bf16_scores=True,
                            remat_policy="dots_nb")
    a = dryrun.run_cell("whisper-small", "train_4k", "single", base)
    b = dryrun.run_cell("whisper-small", "train_4k", "single", knobs)
    assert a["status"] == b["status"] == "ok"
    # float32 parameters and two moments, halved; batch and step unchanged
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import LM
    mesh = make_production_mesh()
    params = LM(get_config("whisper-small"), device="meta").params()
    p_opt = sharding.device_bytes(params, sharding.param_shardings(
        params, mesh, "opt"), mesh)
    p_base = sharding.device_bytes(params, sharding.param_shardings(
        params, mesh), mesh)
    assert b["memory_analysis"]["argument_size_in_bytes"] - 3 * p_opt // 2 \
        == a["memory_analysis"]["argument_size_in_bytes"] - 3 * p_base
    assert b["ops"]["global"]["matmul_flops"] < \
        a["ops"]["global"]["matmul_flops"]
    assert not sharding.want_bf16_scores()
    assert sharding.current_mesh() is None
