"""Checkpoints that both packages open: the port writes the reference's
layout (stacked leaves under the reference's paths), reads the reference's
checkpoints, and the reference reads the port's.

The same training state (the reference's parameters and AdamW moments,
carried across with ``params_from_numpy``) saved by both packages gives
equal manifests: keys, files, names, shapes, dtypes and adler32 of the
leaf bytes.  A training run resumed by one package's ``TrainSupervisor``
from the other's checkpoint takes the next step as the writer's own
resumed run does: losses at rtol 1e-4, both packages in float32 compute.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.distributed import checkpoint as r_ckpt
from repro.distributed import fault_tolerance as r_ft
from repro.models import layers as r_layers
from repro.models import transformer as r_transformer
from repro.models.transformer import LM as RLM
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.distributed import checkpoint as t_ckpt
from repro_torch.distributed import fault_tolerance as t_ft
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train import optimizer as t_opt
from repro_torch.train.step import make_train_step as t_make_train_step

# one arch of each family with a stacked tree: dense and moe (``blocks``),
# hybrid (``groups`` over two dimensions, ``rest``, ``shared``) and the
# encoder-decoder (``enc_blocks``, ``dec_blocks``)
ARCHS = ["qwen2-0.5b", "arctic-480b", "zamba2-1.2b", "whisper-small"]
STEP = 4


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep these models from starving other files' timing-sensitive
    tests of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _state(name, moments="f32"):
    """The reference's training state of the reduced ``name`` (parameters,
    AdamW moments filled from a seed, step, the compressed loop's error)
    and the port's copy of it."""
    cfg = R_ARCHS[name].reduced()
    r_params = RLM(cfg).init(jax.random.PRNGKey(0))
    adam = r_opt.AdamW(r_opt.AdamWConfig(moment_dtype=moments))
    inner = adam.init(r_params)
    rng = np.random.default_rng(1)
    fill = lambda p: jnp.asarray(  # noqa: E731
        rng.standard_normal(p.shape).astype(np.float32), p.dtype)
    inner = {"m": jax.tree.map(fill, inner["m"]),
             "v": jax.tree.map(lambda p: jnp.abs(fill(p)), inner["v"]),
             "step": jnp.asarray(STEP, jnp.int32)}
    error = jax.tree.map(fill, r_params)
    r_state = {"params": r_params, "opt": {"inner": inner, "error": error}}

    tcfg = T_ARCHS[name].reduced()
    dt = torch.bfloat16 if moments == "bf16" else torch.float32

    def port(tree, dtype=torch.float32):
        arrays = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
        return {k: v.to(dtype) for k, v in
                params_from_numpy(tcfg, arrays, device="cpu").items()}
    t_state = {"params": port(r_params), "opt": {
        "inner": {"m": port(inner["m"], dt), "v": port(inner["v"], dt),
                  "step": torch.tensor(STEP, dtype=torch.int32)},
        "error": port(error)}}
    return r_state, t_state


def _manifest(d, step=STEP):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _assert_same(t_tree, r_tree):
    """Every leaf of the port's tree equals the reference's leaf it is
    cut from, bit for bit."""
    t_flat = t_ckpt._leaf_paths(t_tree)
    r_flat = {k: np.asarray(v) for k, v in r_ckpt._leaf_paths(r_tree).items()}
    assert len(t_flat) >= len(r_flat)
    for key, t in t_flat.items():
        ref, idx = t_ckpt._split_key(key)
        want = r_flat[ref][idx] if idx else r_flat[ref]
        got = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        if want.dtype == ml_dtypes.bfloat16 or want.dtype.kind == "V":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("name", ARCHS)
def test_manifests_equal_and_each_opens_the_other(tmp_path, name):
    r_state, t_state = _state(name)
    r_dir, t_dir = tmp_path / "reference", tmp_path / "port"
    r_ckpt.save(str(r_dir), STEP, r_state, extra={"next_step": STEP})
    t_ckpt.save(str(t_dir), STEP, t_state, extra={"next_step": STEP})
    r_man, t_man = _manifest(r_dir), _manifest(t_dir)
    assert t_man == r_man
    # the stacked trees: the reference's paths, leading stacked dimensions
    keys = set(t_man["leaves"])
    stacked = {"qwen2-0.5b": "blocks/layers/0/attn/wq",
               "arctic-480b": "blocks/layers/0/moe/wi",
               "zamba2-1.2b": "groups/ssm/in_proj",
               "whisper-small": "enc_blocks/attn/wq"}[name]
    assert {"params/" + stacked, "opt/inner/m/" + stacked} <= keys
    assert not any("." in k for k in keys)

    # the port opens the reference's checkpoint, onto its own leaves
    step, got, extra = t_ckpt.load(str(r_dir), _zeros_like(t_state))
    assert step == STEP and extra == {"next_step": STEP}
    _assert_same(got, r_state)
    assert got["opt"]["inner"]["step"].dtype == torch.int32
    # and the reference opens the port's
    like = jax.tree.map(np.zeros_like, _np_tree(r_state))
    step, got_r, extra = r_ckpt.load(str(t_dir), like)
    assert step == STEP and extra == {"next_step": STEP}
    _assert_same(t_state, got_r)


def test_bfloat16_moments_cross_both_ways(tmp_path):
    """A bfloat16 leaf (AdamW moments at ``moment_dtype="bf16"``): the port
    writes raw uint16 under ``"dtype": "bfloat16"``, the reference's
    ``ml_dtypes`` array is stored by NumPy as 2-byte void under the same
    dtype string; the manifests are equal and each package reads the
    other's bits."""
    r_state, t_state = _state("arctic-480b", moments="bf16")
    r_dir, t_dir = tmp_path / "reference", tmp_path / "port"
    r_ckpt.save(str(r_dir), STEP, r_state)
    t_ckpt.save(str(t_dir), STEP, t_state)
    r_man, t_man = _manifest(r_dir), _manifest(t_dir)
    assert t_man == r_man
    key = "opt/inner/m/blocks/layers/0/moe/wi"
    assert r_man["leaves"][key]["dtype"] == "bfloat16"
    # the port reads the reference's void entries as bfloat16
    _, got, _ = t_ckpt.load(str(r_dir), _zeros_like(t_state))
    m = got["opt"]["inner"]["m"]
    assert all(v.dtype == torch.bfloat16 for v in m.values())
    _assert_same(got, r_state)
    # the reference reads the port's uint16 entries: the same bits
    like = jax.tree.map(np.zeros_like, _np_tree(r_state))
    _, got_r, _ = r_ckpt.load(str(t_dir), like)
    raw = np.asarray(got_r["opt"]["inner"]["m"]["blocks"]["layers"][0]["moe"]
                     ["wi"])
    want = np.asarray(r_state["opt"]["inner"]["m"]["blocks"]["layers"][0]
                      ["moe"]["wi"])
    np.testing.assert_array_equal(raw.view(ml_dtypes.bfloat16), want)
    _assert_same(t_state, got_r)


def test_old_layout_is_refused(tmp_path):
    """The layout that the port wrote before (one leaf a parameter under
    its dotted name) is refused, with an error that names it."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    r_ckpt.save(str(tmp_path), 1,
                {"params": {"blocks.0.layers.0.attn.wq": w}})
    like = {"params": {"blocks.0.layers.0.attn.wq": torch.zeros(3, 4)}}
    with pytest.raises(ValueError, match="earlier checkpoint layout"):
        t_ckpt.load(str(tmp_path), like)


def _batch(step, vocab):
    rng = np.random.default_rng(100 + step)
    return rng.integers(0, vocab, (2, 16)).astype(np.int32)


def _reference_run(name, ckpt_dir, n_steps, start=0, fail=None):
    cfg = R_ARCHS[name].reduced()
    model = RLM(cfg)
    params = model.init(jax.random.PRNGKey(7))
    adam = r_opt.AdamW(r_opt.AdamWConfig(lr=1e-2, warmup_steps=1,
                                         total_steps=10))
    step_fn = jax.jit(r_make_train_step(model, adam))
    sup = r_ft.TrainSupervisor(
        r_ft.SupervisorConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2),
        step_fn, {"params": params, "opt": adam.init(params)},
        lambda s: {"tokens": jnp.asarray(_batch(s, cfg.vocab))})
    sup.inject_failure_at = fail
    return sup.run(n_steps, start_step=start)


def _port_run(name, ckpt_dir, n_steps, start=0, fail=None):
    cfg = T_ARCHS[name].reduced()
    model = TLM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(7))
    adam = t_opt.AdamW(t_opt.AdamWConfig(lr=1e-2, warmup_steps=1,
                                         total_steps=10))
    sup = t_ft.TrainSupervisor(
        t_ft.SupervisorConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2),
        t_make_train_step(model, adam),
        {"params": params, "opt": adam.init(params)},
        lambda s: {"tokens": torch.from_numpy(_batch(s, cfg.vocab))})
    sup.inject_failure_at = fail
    return sup.run(n_steps, start_step=start)


RUNS = {"reference": _reference_run, "port": _port_run}


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_supervisor_resumes_from_the_other_packages_checkpoint(
        tmp_path, monkeypatch, writer, reader):
    """The writer trains 3 steps, checkpointing after step 2; its own
    supervisor, failing at step 2, restores that checkpoint and takes step
    2 again.  The reader's supervisor, started at step 2 over a copy of the
    writer's directory and failing there, restores the writer's checkpoint
    and takes the same step: the same loss (rtol 1e-4)."""
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(r_transformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    name = "arctic-480b"
    written = tmp_path / "written"
    first = RUNS[writer](name, written, 3)
    assert first.restarts == 0 and len(first.losses) == 3
    mine, theirs = tmp_path / "own_resume", tmp_path / "cross_resume"
    shutil.copytree(written, mine)
    shutil.copytree(written, theirs)
    own = RUNS[writer](name, mine, 3, start=2, fail=2)
    cross = RUNS[reader](name, theirs, 3, start=2, fail=2)
    assert own.restarts == cross.restarts == 1
    assert len(own.losses) == len(cross.losses) == 1
    np.testing.assert_allclose(own.losses[0], first.losses[2], rtol=1e-5)
    np.testing.assert_allclose(cross.losses[0], own.losses[0], rtol=1e-4)
