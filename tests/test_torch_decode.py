"""repro_torch LM decode (caches, decode_attention, serve_step) against the
reference package on the CPU, for all ten archs at their reduced sizes.
The greedy loop and the serving CLI are in ``test_torch_serve_loop.py``.

Weights are the reference's, carried across by ``params_from_numpy``;
prompts and frames come from a NumPy seed.  Tolerances:

* with both packages' ``COMPUTE_DTYPE`` set to float32: logits and caches
  rtol=atol=1e-4, with the caches that the reference holds in bfloat16
  (self K/V, cross K/V) held in float32 by both packages for this
  comparison.  Against a bfloat16 cache the attention probabilities are
  cast to bfloat16, and a float32 probability that differs in its last
  bits can round to the other neighbour (a 4e-3 change in a logit, seen
  on codeqwen1.5-7b); the bfloat16 run holds the caches as the reference
  does;
* at the default bfloat16 compute: rtol=atol=0.15, the reference's own
  decode-vs-forward tolerance (``tests/test_models.py``).
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs.base import ShapeConfig
from repro.configs.input_specs import concrete_batch
from repro.models import attention as r_attn
from repro.models import decode as r_dec
from repro.models import layers as r_layers
from repro.models import transformer as r_transformer
from repro.models.transformer import LM as RLM
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import attention as t_attn
from repro_torch.models import decode as t_dec
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train.step import make_prefill_step, make_serve_step

ARCHS = sorted(R_ARCHS)
B, S, S_MAX = 2, 8, 16


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


def _port(name, cfg=None):
    """The port's reduced model (or ``cfg``) holding the reference's
    weights."""
    _, r_params = _reference(name)
    cfg = cfg or T_ARCHS[name].reduced()
    model = TLM(cfg, device="cpu")
    model.load_params(params_from_numpy(
        cfg, jax.tree.map(np.asarray, r_params), device="cpu"))
    return model


def _inputs(cfg, n_tokens=S, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, n_tokens)).astype(np.int32)
    frontend = None
    if cfg.n_frontend_positions:
        frontend = rng.standard_normal(
            (B, cfg.n_frontend_positions, cfg.d_model)).astype(np.float32)
    return tokens, frontend


def _float32(monkeypatch):
    monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(r_transformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_decode(model, tokens, frontend, S_max=S_MAX):
    """Teacher-forced logits (B, S, V) of the port's serve_step, and the
    final cache."""
    cache = t_dec.init_cache(model, B, S_max)
    if model.cfg.enc_dec:
        cache["xk"], cache["xv"] = t_dec.encdec_prefill_cross(
            model, torch.from_numpy(frontend))
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = t_dec.serve_step(model, cache,
                                     torch.from_numpy(tokens[:, i:i + 1]))
        outs.append(lg)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_serve_step_matches_reference(monkeypatch, name, dtype):
    r_model, r_params = _reference(name)
    t_model = _port(name)
    tokens, frontend = _inputs(t_model.cfg)
    r_cache = r_dec.init_cache(r_model, B, S_MAX)
    t_cache = t_dec.init_cache(t_model, B, S_MAX)
    if r_model.cfg.enc_dec:
        r_cache["xk"], r_cache["xv"] = r_dec.encdec_prefill_cross(
            r_model, r_params, jnp.asarray(frontend))
        t_cache["xk"], t_cache["xv"] = t_dec.encdec_prefill_cross(
            t_model, torch.from_numpy(frontend))
    for key in set(r_cache) - {"length"}:
        assert t_cache[key].shape == r_cache[key].shape, key
        assert str(t_cache[key].dtype).endswith(str(r_cache[key].dtype)), key
    tol = 0.15
    if dtype == "float32":
        _float32(monkeypatch)
        tol = 1e-4
        r_cache = {k: v if k == "length" else v.astype(jnp.float32)
                   for k, v in r_cache.items()}
        t_cache = {k: v if k == "length" else v.float()
                   for k, v in t_cache.items()}
    step = jax.jit(lambda p, c, t: r_dec.serve_step(r_model, p, c, t))
    r_logits = []
    for i in range(S):
        lg, r_cache = step(r_params, r_cache, jnp.asarray(tokens[:, i:i + 1]))
        r_logits.append(np.asarray(lg, np.float32))
    t_logits = []
    for i in range(S):
        lg, t_cache = t_dec.serve_step(t_model, t_cache,
                                       torch.from_numpy(tokens[:, i:i + 1]))
        t_logits.append(_np(lg))
    np.testing.assert_allclose(np.concatenate(t_logits, axis=1),
                               np.concatenate(r_logits, axis=1),
                               rtol=tol, atol=tol)
    assert t_cache["length"] == int(r_cache["length"]) == S
    assert sorted(t_cache) == sorted(r_cache)
    for key in sorted(set(r_cache) - {"length"}):
        np.testing.assert_allclose(_np(t_cache[key]), _np(r_cache[key]),
                                   rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """The reference's own property, on the port and on the reference
    test's own inputs (``tests/test_models.py::test_decode_matches_forward``):
    teacher-forced decode logits == the full forward's.  On other inputs
    the forward's capacity can drop tokens that the drop-free decode keeps
    (llama4's reduced top-1 router: int(2.0 * 16 / 4) = 8 slots an
    expert), and then the reference fails the property as well.  The vlm
    decode skips the frontend prefix, so its forward runs on the text alone
    here (the reference's test only compares shapes)."""
    model = _port(name)
    cfg = R_ARCHS[name].reduced()
    batch = concrete_batch(cfg, ShapeConfig(
        "tiny", 8 + cfg.n_frontend_positions if not cfg.enc_dec else 8, B,
        "train"))
    tokens = np.array(batch["tokens"])[:, :S]
    frontend = None
    t_batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.enc_dec:
        frontend = np.asarray(batch["frontend"], np.float32)
        t_batch["frontend"] = torch.from_numpy(frontend)
    with torch.no_grad():
        full, _ = model(t_batch)
    dec, _ = _port_decode(model, tokens, frontend)
    assert dec.shape == full.shape == (B, S, model.cfg.vocab)
    assert np.isfinite(_np(dec)).all()
    np.testing.assert_allclose(_np(dec), _np(full), rtol=0.15, atol=0.15)


def test_gemma2_sliding_window_masks_in_decode(monkeypatch):
    """S = 12 tokens against the reduced window of 8: the window masks the
    first keys from position 8 on (at S = 8 it never masks anything)."""
    _float32(monkeypatch)
    name, n = "gemma2-9b", 12
    r_model, r_params = _reference(name)
    model = _port(name)
    assert model.plans[0].window == 8 and model.plans[1].window is None
    tokens, _ = _inputs(model.cfg, n_tokens=n, seed=4)
    cache = r_dec.init_cache(r_model, B, S_MAX)
    step = jax.jit(lambda p, c, t: r_dec.serve_step(r_model, p, c, t))
    want = []
    for i in range(n):
        lg, cache = step(r_params, cache, jnp.asarray(tokens[:, i:i + 1]))
        want.append(np.asarray(lg, np.float32))
    got, _ = _port_decode(model, tokens, None)
    np.testing.assert_allclose(_np(got), np.concatenate(want, axis=1),
                               rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        full, _ = model({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(got), _np(full), rtol=0.15, atol=0.15)
    # the same weights with a window that never masks: equal up to
    # position 8, different after it
    wide = _port(name, replace(model.cfg, sliding_window=S_MAX))
    unmasked, _ = _port_decode(wide, tokens, None)
    diff = np.abs(_np(got) - _np(unmasked)).max(axis=(0, 2))
    assert (diff[:8] == 0).all() and (diff[8:] > 1e-3).all(), diff


def test_kv_cache_overflow_raises_where_the_reference_clamps(monkeypatch):
    _float32(monkeypatch)
    rng = np.random.default_rng(5)
    D, H, KV, hd, S_max = 16, 4, 2, 4, 4
    r_spec = r_attn.AttnSpec(H, KV, hd)
    t_spec = t_attn.AttnSpec(H, KV, hd)
    p = {k: rng.standard_normal(sh).astype(np.float32) * 0.3
         for k, sh in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                       ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    xs = rng.standard_normal((S_max + 1, 2, 1, D)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    r_cache = r_attn.KVCache.zeros(2, S_max, KV, hd)
    t_cache = t_attn.KVCache.zeros(2, S_max, KV, hd)
    for x in xs[:S_max]:
        r_out, r_cache = r_attn.decode_attention(rp, r_spec,
                                                 jnp.asarray(x), r_cache)
        t_out, t_cache = t_attn.decode_attention(tp, t_spec,
                                                 torch.from_numpy(x), t_cache)
        np.testing.assert_allclose(_np(t_out), _np(r_out), rtol=0.15,
                                   atol=0.15)
    np.testing.assert_array_equal(_np(t_cache.k), _np(r_cache.k))
    assert t_cache.length == int(r_cache.length) == S_max
    # one write past S_max: the reference clamps the start to S_max - 1
    # and overwrites the last slot; the port raises and leaves the cache
    before = t_cache.k.clone()
    _, r_over = r_attn.decode_attention(rp, r_spec, jnp.asarray(xs[S_max]),
                                        r_cache)
    assert int(r_over.length) == S_max + 1
    assert not np.array_equal(_np(r_over.k)[:, -1], _np(r_cache.k)[:, -1])
    np.testing.assert_array_equal(_np(r_over.k)[:, :-1],
                                  _np(r_cache.k)[:, :-1])
    with pytest.raises(ValueError, match="cannot write position 4"):
        t_attn.decode_attention(tp, t_spec, torch.from_numpy(xs[S_max]),
                                t_cache)
    assert torch.equal(t_cache.k, before)
    # and at the LM's level: a cache of S_max positions takes S_max tokens
    model = _port("qwen2-0.5b")
    tokens, _ = _inputs(model.cfg, n_tokens=S_max)
    _, cache = _port_decode(model, tokens, None, S_max=S_max)
    k = cache["k"].clone()
    with pytest.raises(ValueError, match="holds 4 positions"):
        t_dec.serve_step(model, cache, torch.from_numpy(tokens[:, :1]))
    assert cache["length"] == S_max and torch.equal(cache["k"], k)


def test_step_factories_match_the_functions():
    model = _port("mamba2-780m")
    tokens, _ = _inputs(model.cfg)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        want, _ = model(batch)
        assert torch.equal(make_prefill_step(model)(batch), want)
    step = make_serve_step(model)
    c1 = t_dec.init_cache(model, B, S_MAX)
    c2 = t_dec.init_cache(model, B, S_MAX)
    for i in range(3):
        tok = torch.from_numpy(tokens[:, i:i + 1])
        a, c1 = step(c1, tok)
        b, c2 = t_dec.serve_step(model, c2, tok)
        assert torch.equal(a, b)
    assert all(torch.equal(c1[k], c2[k]) for k in ("h", "conv"))
