"""Activation checkpointing and the bfloat16-score attention against the
reference.

Each remat policy (``full``, ``dots_nb``, ``none``) gives the reference's
loss and gradients, in float32 through ``params_from_numpy`` at the LM
tests' tolerances (``test_torch_models.py``): rtol 1e-4, with an absolute
floor of 1e-4 x the leaf's largest gradient.  The recomputation must run
on the parameters the forward ran on: the leaves that ``LM.loss`` binds
with ``functional_call``, not the model's own (zeros here).  The
bfloat16-score ``_sdpa`` that the mesh rules switch on matches the
reference's with its flag set, and the default path is unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.distributed import sharding as r_shd
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import transformer as r_transformer
from repro.models.transformer import LM as RLM
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.distributed import sharding as t_shd
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train.step import value_and_grad

POLICIES = ["full", "dots_nb", "none"]
# the hybrid and the encoder-decoder are in test_torch_remat_hybrid.py
ARCHS = ["qwen2-0.5b", "arctic-480b", "mamba2-780m"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bf16_scores():
    """Both packages' mesh rules with the bfloat16-score switch on."""
    r_shd.use_mesh_rules(None, bf16_scores=True)
    t_shd.use_mesh_rules(None, bf16_scores=True)
    yield
    r_shd.use_mesh_rules(None)
    t_shd.use_mesh_rules(None)


@pytest.fixture
def float32(monkeypatch):
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(r_transformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)


def _setup(name, policy, seed=3, B=2, S=16):
    r_cfg = dataclasses.replace(R_ARCHS[name].reduced(), remat_policy=policy)
    t_cfg = dataclasses.replace(T_ARCHS[name].reduced(), remat_policy=policy)
    r_model = RLM(r_cfg)
    r_params = r_model.init(jax.random.PRNGKey(seed))
    t_model = TLM(t_cfg, device="cpu")
    t_params = params_from_numpy(t_cfg, jax.tree.map(np.asarray, r_params),
                                 device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, r_cfg.vocab, (B, S)).astype(np.int32)}
    if r_cfg.n_frontend_positions:
        batch["frontend"] = rng.standard_normal(
            (B, r_cfg.n_frontend_positions, r_cfg.d_model)).astype(np.float32)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return r_model, r_params, t_model, t_params, rb, tb


def _check_loss_and_grads(name, policy):
    r_model, r_params, t_model, t_params, rb, tb = _setup(name, policy)
    r_loss, r_grads = jax.value_and_grad(r_model.loss)(r_params, rb)
    t_loss, t_grads = value_and_grad(t_model, t_params, tb)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-4)
    want = params_from_numpy(t_model.cfg, jax.tree.map(np.asarray, r_grads),
                             device="cpu")
    assert list(t_grads) == list(want)
    for k, g in t_grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_under_each_policy(float32, name,
                                                          policy):
    _check_loss_and_grads(name, policy)


def test_recomputation_uses_the_bound_parameters(float32):
    """The model's own parameters are zeros; ``LM.loss(batch, params)``
    binds others.  Under ``full`` the backward's recomputation must use
    those, so the gradients equal ``none``'s exactly."""
    grads = {}
    for policy in ("full", "none"):
        _, _, t_model, t_params, _, tb = _setup("qwen2-0.5b", policy)
        assert all(float(p.detach().abs().max()) == 0.0
                   for p in t_model.parameters())
        grads[policy] = value_and_grad(t_model, t_params, tb)[1]
    for k, g in grads["full"].items():
        torch.testing.assert_close(g, grads["none"][k], rtol=0, atol=0)


def test_unknown_policy_raises():
    _, _, t_model, t_params, _, tb = _setup("qwen2-0.5b", "selective")
    with pytest.raises(ValueError, match="remat_policy"):
        value_and_grad(t_model, t_params, tb)


def _qkv(seed, dtype_r, dtype_t, B=2, S=12, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32) * 2
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32) * 2
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return ([jnp.asarray(a, dtype_r) for a in (q, k, v)],
            [torch.from_numpy(a).to(dtype_t) for a in (q, k, v)])


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 5])
def test_bf16_scores_sdpa_matches_reference(bf16_scores, cap, window):
    spec_r = r_attn.AttnSpec(4, 2, 16, attn_softcap=cap)
    spec_t = t_attn.AttnSpec(4, 2, 16, attn_softcap=cap)
    (rq, rk, rv), (tq, tk, tv) = _qkv(0, jnp.bfloat16, torch.bfloat16)
    want = r_attn._sdpa(rq, rk, rv, r_attn.causal_mask(12, 12, 0, window),
                        spec_r)
    got = t_attn._sdpa(tq, tk, tv, t_attn.causal_mask(12, 12, 0, window),
                       spec_t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_default_scores_path_is_unchanged():
    """Flag off: float32 scores, the reference's default; the flag changes
    the result (scores rounded to bfloat16)."""
    spec_r = r_attn.AttnSpec(4, 2, 16)
    spec_t = t_attn.AttnSpec(4, 2, 16)
    (rq, rk, rv), (tq, tk, tv) = _qkv(1, jnp.bfloat16, torch.bfloat16)
    mask_r, mask_t = r_attn.causal_mask(12, 12, 0), t_attn.causal_mask(12, 12)
    default = t_attn._sdpa(tq, tk, tv, mask_t, spec_t)
    np.testing.assert_allclose(
        default.float().numpy(),
        np.asarray(r_attn._sdpa(rq, rk, rv, mask_r, spec_r), np.float32),
        rtol=2e-2, atol=2e-2)
    t_shd.use_mesh_rules(None, bf16_scores=True)
    try:
        flagged = t_attn._sdpa(tq, tk, tv, mask_t, spec_t)
    finally:
        t_shd.use_mesh_rules(None)
    assert not torch.equal(flagged, default)
    assert torch.equal(t_attn._sdpa(tq, tk, tv, mask_t, spec_t), default)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "gemma2-9b"])
def test_bf16_scores_loss_and_grads_match_reference(bf16_scores, float32,
                                                    name):
    """With the switch on, in float32 compute: the max taken out of the
    gradient (``detach``, the reference's ``stop_gradient``) and the
    -30000 mask give the reference's loss and gradients."""
    _check_loss_and_grads(name, "full")


def test_bf16_scores_loss_matches_reference_in_bf16(bf16_scores):
    r_model, r_params, t_model, t_params, rb, tb = _setup("qwen2-0.5b",
                                                          "full")
    want = float(r_model.loss(r_params, rb))
    got = float(t_model.loss(tb, t_params))
    assert abs(got - want) <= 1e-2, (got, want)
