"""The LM parity tests again, with every all-zero leaf of the reference's
``LM.init`` filled, for all ten archs at their reduced sizes.

The reference starts every norm scale and bias at zero.  Its LayerNorms
multiply by the scale, so a fresh whisper-small or command-r-35b outputs
all-zero logits, and a parity test on those weights compares zeros below
the final norm.  Here each all-zero leaf is drawn from a NumPy seed:
LayerNorm scales 1 + 0.1 N(0, 1), every other one (RMSNorm scales, used as
1 + scale; biases; an SSM's ``conv_b`` and ``dt_bias``) 0.1 N(0, 1).  The
weights are carried across with ``params_from_numpy``.

Tolerances, both packages in float32 compute (the same as
``tests/test_torch_models.py::test_lm_loss_and_grads_match_reference_f32``
and the float32 case of ``tests/test_torch_decode.py``): the loss rtol
1e-4; every gradient rtol 1e-4 with an absolute floor of 1e-4 x the
leaf's largest gradient; the teacher-forced ``serve_step`` logits rtol =
atol = 1e-4, with both packages' caches held in float32.  That includes
the encoder-decoder's cross K/V: ``encdec_prefill_cross`` casts them to
the cache's bfloat16 in both packages, and float32 values a few ulps
apart can round to neighbouring bfloat16 values (whisper-small at seed
5: one cross V entry 0.00195 apart, its logits then 3e-4).  So here each
package's own encoder and cross projections give them, in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.models import decode as r_dec
from repro.models import layers as r_layers
from repro.models import transformer as r_transformer
from repro.models.transformer import LM as RLM
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import decode as t_dec
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train.step import value_and_grad

ARCHS = sorted(R_ARCHS)
LAYER_NORM_SCALES = ("ln1", "ln2", "ln3", "ln_f", "ln_enc")
B, S, S_MAX = 2, 8, 16


@pytest.fixture(autouse=True)
def _float32_two_threads(monkeypatch):
    """Both packages in float32 compute; two intra-op threads a test, as
    the other LM files run beside the rest of the suite."""
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(r_transformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _filled(cfg, params, seed):
    """``params`` (the reference's tree) with its all-zero leaves drawn
    from ``seed``; the names of the leaves filled."""
    rng = np.random.default_rng(seed)
    filled = []

    def fill(path, leaf):
        a = np.asarray(leaf)
        if a.any():
            return a
        name = path[-1].key
        filled.append(jax.tree_util.keystr(path))
        noise = 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        if cfg.norm == "layer" and name in LAYER_NORM_SCALES:
            return 1.0 + noise
        return noise

    return jax.tree_util.tree_map_with_path(fill, params), filled


def _setup(name, seed):
    cfg = R_ARCHS[name].reduced()
    r_model = RLM(cfg)
    r_params, filled = _filled(cfg, r_model.init(jax.random.PRNGKey(seed)),
                               seed)
    assert filled and not [k for k, v in jax.tree_util.tree_leaves_with_path(
        r_params) if not np.asarray(v).any()]
    t_model = TLM(T_ARCHS[name].reduced(), device="cpu")
    t_params = params_from_numpy(t_model.cfg, r_params, device="cpu")
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_frontend_positions:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_positions, cfg.d_model)).astype(np.float32)
    return r_model, r_params, t_model, t_params, batch


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_with_filled_norms(name):
    r_model, r_params, t_model, t_params, batch = _setup(name, seed=3)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
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
    # below the final norm something moves: more than its two leaves
    assert sum(bool(np.abs(want[k].numpy()).max()) for k in want) > 2


def _cross_float32(r_model, r_params, t_model, frontend):
    """``encdec_prefill_cross`` of each package without its last step, the
    cast to bfloat16: (reference K, V, port K, V), (L, B, M, KV, hd)."""
    memory = r_model._encoder(r_params, jnp.asarray(frontend))
    r_k, r_v = jax.vmap(lambda lp: r_dec._project_qkv(
        lp["xattn"], r_model.attn_spec, memory, memory)[1:])(
            r_params["dec_blocks"])
    with torch.no_grad():
        memory = t_model._encoder(torch.from_numpy(frontend))
        kv = [[t_dec.project(lp.xattn.params(), t_model.attn_spec, memory,
                             which) for lp in t_model.dec_blocks]
              for which in ("k", "v")]
    return r_k, r_v, torch.stack(kv[0]), torch.stack(kv[1])


@pytest.mark.parametrize("name", ARCHS)
def test_serve_step_logits_match_reference_with_filled_norms(name):
    r_model, r_params, t_model, t_params, batch = _setup(name, seed=5)
    t_model.load_params(t_params)
    tokens = batch["tokens"]
    r_cache = r_dec.init_cache(r_model, B, S_MAX)
    t_cache = t_dec.init_cache(t_model, B, S_MAX)
    r_cache = {k: v if k == "length" else v.astype(jnp.float32)
               for k, v in r_cache.items()}
    t_cache = {k: v if k == "length" else v.float()
               for k, v in t_cache.items()}
    if r_model.cfg.enc_dec:
        r_cache["xk"], r_cache["xv"], t_cache["xk"], t_cache["xv"] = \
            _cross_float32(r_model, r_params, t_model, batch["frontend"])
    step = jax.jit(lambda p, c, t: r_dec.serve_step(r_model, p, c, t))
    r_logits, t_logits = [], []
    for i in range(S):
        lg, r_cache = step(r_params, r_cache, jnp.asarray(tokens[:, i:i + 1]))
        r_logits.append(np.asarray(lg, np.float32))
        with torch.no_grad():
            lg, t_cache = t_dec.serve_step(
                t_model, t_cache, torch.from_numpy(tokens[:, i:i + 1]))
        t_logits.append(lg.float().numpy())
    want = np.concatenate(r_logits, axis=1)
    np.testing.assert_allclose(np.concatenate(t_logits, axis=1), want,
                               rtol=1e-4, atol=1e-4)
    assert np.abs(want).max() > 0.1     # not a comparison of zeros
