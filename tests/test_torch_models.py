"""repro_torch models vs the reference package on the CPU.

The same NumPy inputs, made from a seed, go through the reference's JAX
function and the port's.  Weights are the reference's, carried across by
``params_from_numpy``.  Tolerances:

* building blocks in float32: rtol=1e-5 (float32 math in another order);
* the LM loss at the default bfloat16 compute: |loss difference| <= 1e-2
  (bfloat16 rounds at the same places, but matmuls accumulate in another
  order and a product can round to the other neighbour);
* the LM loss and every gradient with both packages' ``COMPUTE_DTYPE`` set
  to float32: rtol=1e-4, with an absolute floor of 1e-4 x the leaf's
  largest gradient for entries that cancel to near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import transformer as r_transformer
from repro.models.transformer import LM as RLM
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy

LOSS_ARCHS = sorted(R_ARCHS)
# float32 loss and gradient parity: three dense archs and one arch of each
# other family (moe, ssm, hybrid, encoder-decoder)
GRAD_ARCHS = ["qwen2-0.5b", "gemma2-9b", "command-r-35b", "arctic-480b",
              "mamba2-780m", "zamba2-1.2b", "whisper-small"]


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep these models from starving other files' timing-sensitive
    tests of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def test_configs_match_reference():
    assert sorted(T_ARCHS) == sorted(R_ARCHS)
    for name, r in R_ARCHS.items():
        t = T_ARCHS[name]
        for full_t, full_r in ((t, r), (t.reduced(), r.reduced())):
            a, b = dict(vars(full_t)), dict(vars(full_r))
            for key in ("moe", "ssm"):
                a[key] = tuple(a[key]) if a[key] is not None else None
                b[key] = tuple(b[key]) if b[key] is not None else None
            assert a == b, name


# -- building blocks ---------------------------------------------------------

def test_rms_and_layer_norm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    s = rng.standard_normal(32).astype(np.float32) * 0.1
    b = rng.standard_normal(32).astype(np.float32) * 0.1
    for xdt_r, xdt_t in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
        want = r_layers.rms_norm(jnp.asarray(s), jnp.asarray(x, xdt_r))
        got = t_layers.rms_norm(_t(s), _t(x).to(xdt_t))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=1e-2)
    want = r_layers.layer_norm(jnp.asarray(s), jnp.asarray(b),
                               jnp.asarray(x))
    got = t_layers.layer_norm(_t(s), _t(b), _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-2)


def test_blocks_match_reference_in_float32(monkeypatch):
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        _np(t_layers.rms_norm(_t(s), _t(x))),
        np.asarray(r_layers.rms_norm(jnp.asarray(s), jnp.asarray(x))),
        rtol=1e-5)
    np.testing.assert_allclose(
        _np(t_layers.softcap(_t(x) * 40, 30.0)),
        np.asarray(r_layers.softcap(jnp.asarray(x) * 40, 30.0)), rtol=1e-5)
    # rope on (B, S, H, hd)
    q = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    pos = np.arange(6)[None, :]
    np.testing.assert_allclose(
        _np(t_layers.apply_rope(_t(q), _t(pos), 1e6)),
        np.asarray(r_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                       1e6)), rtol=1e-5, atol=1e-6)
    mlp = {k: rng.standard_normal(sh).astype(np.float32) * 0.2
           for k, sh in (("wi", (16, 24)), ("wg", (16, 24)),
                         ("wo", (24, 16)))}
    np.testing.assert_allclose(
        _np(t_layers.gated_mlp({k: _t(v) for k, v in mlp.items()}, _t(x))),
        np.asarray(r_layers.gated_mlp(
            {k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    gmlp = dict(mlp, bi=rng.standard_normal(24).astype(np.float32),
                bo=rng.standard_normal(16).astype(np.float32))
    np.testing.assert_allclose(
        _np(t_layers.gelu_mlp({k: _t(v) for k, v in gmlp.items()}, _t(x))),
        np.asarray(r_layers.gelu_mlp(
            {k: jnp.asarray(v) for k, v in gmlp.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 6))
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = r_layers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = t_layers.cross_entropy(_t(logits), _t(labels),
                                     None if m is None else _t(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("kv,bias,cap,window", [
    (4, False, None, None), (2, True, None, None), (1, False, 50.0, 3),
    (2, True, 20.0, 4)])
def test_attention_matches_reference(monkeypatch, kv, bias, cap, window):
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    rng = np.random.default_rng(kv * 10 + bool(bias))
    D, H, hd = 32, 4, 8
    rspec = r_attn.AttnSpec(H, kv, hd, bias, cap, 1e4)
    tspec = t_attn.AttnSpec(H, kv, hd, bias, cap, 1e4)
    p = {"wq": (D, H * hd), "wk": (D, kv * hd), "wv": (D, kv * hd),
         "wo": (H * hd, D)}
    if bias:
        p.update(bq=(H * hd,), bk=(kv * hd,), bv=(kv * hd,))
    p = {k: rng.standard_normal(sh).astype(np.float32) * 0.3
         for k, sh in p.items()}
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    mem = rng.standard_normal((2, 5, D)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    want = r_attn.attention(rp, rspec, jnp.asarray(x), window=window)
    got = t_attn.attention(tp, tspec, _t(x), window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = r_attn.cross_attention(rp, rspec, jnp.asarray(x),
                                  jnp.asarray(mem))
    got = t_attn.cross_attention(tp, tspec, _t(x), _t(mem))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        t_attn.causal_mask(5, 9, 2, window).numpy(),
        np.asarray(r_attn.causal_mask(5, 9, 2, window)))


# -- the LM --------------------------------------------------------------------

def _setup(name, seed=0, B=2, S=16):
    r_cfg = R_ARCHS[name].reduced()
    t_cfg = T_ARCHS[name].reduced()
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
    return r_model, r_params, t_model, t_params, batch


def _batches(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_params_from_numpy_names_shapes_and_order(name):
    r_model, r_params, t_model, t_params, _ = _setup(name)
    own = t_model.params()
    assert list(t_params) == list(own)
    for k, v in own.items():
        assert tuple(t_params[k].shape) == tuple(v.shape), k
    # the flat vector of the port's params is the reference's leaf order
    flat_r = np.concatenate([np.asarray(leaf).reshape(-1)
                             for leaf in jax.tree.leaves(r_params)])
    flat_t = torch.cat([v.reshape(-1) for v in t_params.values()]).numpy()
    np.testing.assert_array_equal(flat_t, flat_r)
    t_model.load_params(t_params)
    assert torch.equal(t_model.params()[next(iter(own))],
                       t_params[next(iter(own))])


def test_params_from_numpy_checks_the_config_and_device():
    r_params = RLM(R_ARCHS["gemma2-9b"].reduced()).init(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, r_params)
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(T_ARCHS["command-r-35b"], tree, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            params_from_numpy(T_ARCHS["gemma2-9b"].reduced(), tree)


@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_lm_loss_matches_reference_bf16(name):
    r_model, r_params, t_model, t_params, batch = _setup(name)
    rb, tb = _batches(batch)
    want = float(r_model.loss(r_params, rb))
    got = float(t_model.loss(tb, t_params))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-2, (got, want)
    # the model's own parameters, once loaded, give the same loss
    t_model.load_params(t_params)
    with torch.no_grad():
        assert float(t_model.loss(tb)) == got
    with torch.no_grad():
        logits, aux = t_model(tb)
    assert logits.shape == (2, 16, t_model.cfg.vocab)
    if t_model.cfg.moe is None:
        assert aux == 0.0
    else:
        _, r_aux = r_model.forward(r_params, rb)
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-2)


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_lm_loss_and_grads_match_reference_f32(monkeypatch, name):
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(r_transformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    from repro_torch.train.step import value_and_grad
    r_model, r_params, t_model, t_params, batch = _setup(name, seed=3)
    rb, tb = _batches(batch)
    r_loss, r_grads = jax.value_and_grad(r_model.loss)(r_params, rb)
    t_loss, t_grads = value_and_grad(t_model, t_params, tb)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-4)
    want = params_from_numpy(t_model.cfg,
                             jax.tree.map(np.asarray, r_grads), device="cpu")
    assert list(t_grads) == list(want)
    for k, g in t_grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_lm_init_is_seeded_and_on_the_device():
    cfg = T_ARCHS["qwen2-0.5b"].reduced()
    m = TLM(cfg, device="cpu")
    p1 = {k: v.clone() for k, v in m.init(torch.Generator().manual_seed(5))
          .items()}
    p2 = m.init(torch.Generator().manual_seed(5))
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert float(p2["ln_f"].detach().abs().sum()) == 0
    assert float(p2["embed"].detach().std()) == pytest.approx(cfg.d_model ** -0.5,
                                                     rel=0.1)
    assert all(v.device.type == "cpu" for v in p2.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TLM(cfg)


@pytest.mark.parametrize("name", ["whisper-small", "command-r-35b"])
def test_layer_norm_scales_start_at_one(name):
    """The reference starts LayerNorm scales at zero as it does RMSNorm's
    (which it applies as 1 + scale), so every LayerNorm of a fresh
    whisper or command-r outputs zeros and so do the logits; the port's
    fresh LayerNorms are the identity."""
    r_model, r_params, _, _, batch = _setup(name)
    rb, tb = _batches(batch)
    r_logits, _ = r_model.forward(r_params, rb)
    assert not np.asarray(r_logits, np.float32).any()
    t_model = TLM(T_ARCHS[name].reduced(), device="cpu")
    params = t_model.init(torch.Generator().manual_seed(0))
    assert float(params["ln_f"].detach().min()) == 1.0
    assert float(params["ln_f_b"].detach().abs().max()) == 0.0
    with torch.no_grad():
        logits, _ = t_model(tb)
    assert torch.isfinite(logits).all() and float(logits.float().std()) > 0.1
