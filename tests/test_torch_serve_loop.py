"""repro_torch's greedy serving loop, its launcher and the smoke's LM
phase against the reference package on the CPU: ``generate`` returns the
reference's tokens exactly for all ten archs at their reduced sizes, with
both packages' ``COMPUTE_DTYPE`` set to float32 and the reference's
caches; the launcher and its CLI run on the CPU.
"""
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.models import layers as r_layers
from repro.models import transformer as r_transformer
from repro.models.transformer import LM as RLM
from repro.serve.loop import generate as r_generate
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serve.loop import generate as t_generate

ARCHS = sorted(R_ARCHS)
B, S, S_MAX = 2, 8, 16
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs several workers side by
    side, and these small models run no faster on more."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's reduced model and its weights (seed 0)."""
    model = RLM(R_ARCHS[name].reduced())
    return model, model.init(jax.random.PRNGKey(0))


def _port(name):
    """The port's reduced model holding the reference's weights."""
    _, r_params = _reference(name)
    cfg = T_ARCHS[name].reduced()
    model = TLM(cfg, device="cpu")
    model.load_params(params_from_numpy(
        cfg, jax.tree.map(np.asarray, r_params), device="cpu"))
    return model


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frontend = None
    if cfg.n_frontend_positions:
        frontend = rng.standard_normal(
            (B, cfg.n_frontend_positions, cfg.d_model)).astype(np.float32)
    return tokens, frontend


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference_tokens_f32(monkeypatch, name):
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(r_transformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    r_model, r_params = _reference(name)
    t_model = _port(name)
    prompts, frontend = _inputs(t_model.cfg, seed=2)
    want = r_generate(r_model, r_params, prompts, 8, max_len=S_MAX + 1,
                      frontend=frontend)
    timings = {}
    got = t_generate(t_model, prompts, 8, max_len=S_MAX + 1,
                     frontend=frontend, timings=timings)
    assert got.dtype == np.int32 and got.shape == (B, S + 8)
    np.testing.assert_array_equal(got, want)
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


def test_launch_serve_main_on_cpu():
    from repro_torch.launch import serve
    model, out, report = serve.main(["--device", "cpu", "--arch",
                                     "whisper-small", "--new-tokens", "4"])
    prompts, frontend = serve.make_inputs(model.cfg, 4, 16)
    assert frontend.shape == (4, model.cfg.n_frontend_positions,
                              model.cfg.d_model)
    assert out.shape == (4, 20) and report["shape"] == [4, 20]
    np.testing.assert_array_equal(out[:, :16], prompts)
    assert ((out >= 0) & (out < model.cfg.vocab)).all()
    assert report["reduced"] and report["params"] == sum(
        p.numel() for p in model.parameters())
    assert report["tok_s"] > 0 and report["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main([])


def test_launch_serve_cli_subprocess():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--new-tokens", "4"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[launch.serve:qwen2-0.5b-smoke] 16 tokens" in res.stdout
    assert "shape (4, 20)" in res.stdout


def test_smoke_lm_serve_phase_on_cpu(monkeypatch):
    """The smoke's LM serving phase at the reduced sizes on the CPU: every
    model served through its entry point, checked against its forward
    (arctic: two identical runs), and no kernel launched."""
    from repro_torch.kernels import bitpack_kernel, grad_compress, \
        logical_reduce, popcount, word_logical
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    monkeypatch.setattr(smoke, "LM_FULL", False)
    lines = smoke.lm_serve_phase(torch, (word_logical, logical_reduce,
                                         grad_compress, popcount,
                                         bitpack_kernel))
    assert [line["arch"] for line in lines] == [
        "qwen2-0.5b-smoke", "mamba2-780m-smoke", "zamba2-1.2b-smoke",
        "whisper-small-smoke", "arctic-480b-smoke"]
    for line in lines[:4]:
        assert line["check"]["float32"]["outside_tol"] == 0
        assert line["check"]["bfloat16"]["outside_tol"] == 0
        assert line["reduced"] == ["reduced config"]
    assert lines[-1]["layers"] == 1 and lines[-1]["check"][
        "two_runs_identical"]
    assert lines[-1]["reduced"] == ["n_layers 35 -> 1", "reduced config"]
