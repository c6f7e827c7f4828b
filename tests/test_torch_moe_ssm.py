"""repro_torch MoE dispatch and Mamba-2 SSD against the reference package
on the CPU.

The same NumPy inputs and weights, made from a seed, go through both.
Tolerances: float32 (both packages' ``COMPUTE_DTYPE`` set to float32)
rtol=1e-4, atol=1e-5 (float32 sums in another order); bfloat16 rtol=atol=
2e-2 (products of bfloat16 operands, rounded at the same places, may round
to the other neighbour); routing bitmaps bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.kernels import ops as t_ops
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _dtype(monkeypatch, dtype):
    """Both packages' compute dtype; returns (tolerance kwargs, jnp dtype,
    torch dtype).  The reference reads it while tracing, so each test jits
    its reference calls afresh."""
    if dtype == "float32":
        monkeypatch.setattr(r_layers, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
        return dict(rtol=1e-4, atol=1e-5), jnp.float32, torch.float32
    return dict(rtol=2e-2, atol=2e-2), jnp.bfloat16, torch.bfloat16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


# -- MoE --------------------------------------------------------------------------

# (E, top_k, d_model, d_ff, capacity factor, B, S): the reduced configs'
# MoE, and E=128 top-2 at capacity factor 1.25 (arctic's router) on narrow
# widths, where capacity int(1.25 * 2 * 64 / 128) = 1 drops tokens
MOE_CASES = {
    "reduced": (4, 2, 64, 128, 2.0, 2, 16),
    "reduced-top1": (4, 1, 64, 128, 2.0, 2, 16),
    "arctic-router": (128, 2, 32, 16, 1.25, 2, 32),
}


def _moe_setup(case, seed=0):
    E, k, D, Fd, cf, B, S = MOE_CASES[case]
    spec = dict(n_experts=E, top_k=k, d_ff=Fd, capacity_factor=cf)
    params = jax.tree.map(np.asarray, r_moe.init_moe(
        jax.random.PRNGKey(seed), D, r_moe.MoESpec(**spec)))
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    return r_moe.MoESpec(**spec), t_moe.MoESpec(**spec), params, x


def _stable_keep(topi, E, capacity):
    """Which (token, slot) pairs a stable sort by expert keeps: the first
    ``capacity`` pairs of each expert in (token, slot) order."""
    keep = np.zeros(topi.shape, bool)
    seen = np.zeros(E, int)
    for t in range(topi.shape[0]):
        for j in range(topi.shape[1]):
            e = topi[t, j]
            keep[t, j] = seen[e] < capacity
            seen[e] += 1
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_reference(monkeypatch, case, dtype):
    tol, r_dt, t_dt = _dtype(monkeypatch, dtype)
    r_spec, t_spec, params, x = _moe_setup(case)
    rp, tp = _both(params)
    rx = jnp.asarray(x, r_dt)
    tx = torch.from_numpy(x).to(t_dt)
    # op by op, as the reference rounds each product: the bfloat16 router
    # logits and their ties are the point here
    r_v, r_i, r_logits = r_moe.route(rp, r_spec, rx.reshape(-1, x.shape[-1]))
    t_v, t_i, t_logits = t_moe.route(tp, t_spec, tx.reshape(-1, x.shape[-1]))
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(_np(t_v), _np(r_v), **tol)
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **tol)
    r_y, r_aux = r_moe.moe_block(rp, r_spec, rx)
    t_y, t_aux = t_moe.moe_block(tp, t_spec, tx)
    assert t_y.dtype == t_dt and t_y.shape == tx.shape
    np.testing.assert_allclose(_np(t_y), _np(r_y), **tol)
    np.testing.assert_allclose(float(t_aux), float(r_aux), rtol=1e-5)
    # the tokens that keep no slot are the ones a stable sort drops
    E, k = t_spec.n_experts, t_spec.top_k
    T = x.shape[0] * x.shape[1]
    capacity = max(int(t_spec.capacity_factor * k * T / E), 1)
    topi = t_i.numpy()
    keep = _stable_keep(topi, E, capacity)
    dropped = ~keep.any(axis=1)
    zero_rows = (_np(t_y).reshape(T, -1) == 0).all(axis=1)
    np.testing.assert_array_equal(zero_rows, dropped)
    if case == "arctic-router":
        # some pairs fall past capacity (51 of the 128 in float32)
        assert capacity == 1 and keep.sum() < k * T and dropped.any()
        # a sort that broke ties the other way would keep other tokens
        reverse = _stable_keep(topi[::-1], E, capacity)[::-1]
        assert (reverse.any(axis=1) != keep.any(axis=1)).any()


@pytest.mark.parametrize("case", ["reduced", "arctic-router"])
def test_moe_block_grads_match_reference_f32(monkeypatch, case):
    tol, _, _ = _dtype(monkeypatch, "float32")
    r_spec, t_spec, params, x = _moe_setup(case, seed=1)
    rp, tp = _both(params)

    def r_loss(p, x):
        y, aux = r_moe.moe_block(p, r_spec, x)
        return jnp.sum(y * y) + aux

    r_g, r_gx = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(rp,
                                                          jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_block(tp, t_spec, tx)
    (torch.sum(y * y) + aux).backward()
    for name, p in tp.items():
        w = np.asarray(r_g[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(r_gx), **tol)


@pytest.mark.parametrize("T,E,k", [(512, 8, 1), (100, 128, 2), (33, 5, 3),
                                   (64, 4, 2), (1, 3, 1)])
def test_dispatch_bitmap_words_bit_for_bit(T, E, k):
    rng = np.random.default_rng(T + E + k)
    topi = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    if T > 31:
        topi[31, 0] = 0          # bit 31 of word 0: the int32 sign bit
    want = np.asarray(r_moe.dispatch_bitmap_words(jnp.asarray(topi), E))
    got = t_moe.dispatch_bitmap_words(torch.from_numpy(topi), E)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(t_ops.to_numpy_words(got), want)


# -- Mamba-2 SSD --------------------------------------------------------------------

SSM_SPEC = dict(d_inner=32, state_dim=8, head_dim=8, n_groups=1, chunk=4)


def _ssm_setup(seed=0, spec=SSM_SPEC, D=16):
    params = jax.tree.map(np.asarray, r_ssm.init_ssm(
        jax.random.PRNGKey(seed), D, r_ssm.SSMSpec(**spec)))
    rng = np.random.default_rng(seed)
    params["dt_bias"] = rng.standard_normal(params["dt_bias"].shape).astype(
        np.float32) * 0.5
    params["conv_b"] = rng.standard_normal(params["conv_b"].shape).astype(
        np.float32) * 0.1
    x = rng.standard_normal((2, 16, D)).astype(np.float32) * 0.5
    return r_ssm.SSMSpec(**spec), t_ssm.SSMSpec(**spec), params, x


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_matches_reference_f32(groups, with_h0):
    spec = dict(SSM_SPEC, n_groups=groups)
    rng = np.random.default_rng(groups * 2 + with_h0)
    b, S, H, P, N = 2, 16, 4, 8, 8
    xbar = rng.standard_normal((b, S, H, P)).astype(np.float32) * 0.3
    dA = -np.abs(rng.standard_normal((b, S, H))).astype(np.float32) * 0.2
    Bm = rng.standard_normal((b, S, groups, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((b, S, groups, N)).astype(np.float32) * 0.3
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32) \
        if with_h0 else None
    r_args = [jnp.asarray(a) for a in (xbar, dA, Bm, Cm)]
    t_args = [torch.from_numpy(a) for a in (xbar, dA, Bm, Cm)]
    r_y, r_h = jax.jit(lambda *a: r_ssm.ssd_scan(
        *a[:4], r_ssm.SSMSpec(**spec), h0=a[4]))(
            *r_args, None if h0 is None else jnp.asarray(h0))
    t_y, t_h = t_ssm.ssd_scan(*t_args, t_ssm.SSMSpec(**spec),
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert t_h.dtype == torch.float32
    np.testing.assert_allclose(t_y.numpy(), np.asarray(r_y), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(r_h), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(AssertionError):     # S not a multiple of the chunk
        t_ssm.ssd_scan(*[a[:, :6] for a in t_args], t_ssm.SSMSpec(**spec))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(monkeypatch, dtype):
    tol, r_dt, t_dt = _dtype(monkeypatch, dtype)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = r_ssm._causal_conv(jnp.asarray(u, r_dt), jnp.asarray(w),
                              jnp.asarray(b))
    got = t_ssm._causal_conv(torch.from_numpy(u).to(t_dt),
                             torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == t_dt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_matches_reference(monkeypatch, dtype):
    tol, r_dt, t_dt = _dtype(monkeypatch, dtype)
    r_spec, t_spec, params, x = _ssm_setup()
    rp, tp = _both(params)
    want = jax.jit(lambda p, x: r_ssm.ssm_block(p, r_spec, x))(
        rp, jnp.asarray(x, r_dt))
    got = t_ssm.ssm_block(tp, t_spec, torch.from_numpy(x).to(t_dt))
    assert got.dtype == t_dt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_reference(monkeypatch, dtype):
    """Step by step from zeroed caches (the conv window in bfloat16, as the
    reference allocates it): outputs, the float32 state and the window."""
    tol, r_dt, t_dt = _dtype(monkeypatch, dtype)
    r_spec, t_spec, params, x = _ssm_setup(seed=2)
    rp, tp = _both(params)
    r_c = r_ssm.SSMCache.zeros(2, r_spec)
    t_c = t_ssm.SSMCache.zeros(2, t_spec)
    assert t_c.h.dtype == torch.float32 and t_c.conv.dtype == torch.bfloat16
    outs = []
    r_step = jax.jit(lambda p, x, c: r_ssm.ssm_decode(p, r_spec, x, c))
    for i in range(x.shape[1]):
        r_y, r_c = r_step(rp, jnp.asarray(x[:, i:i + 1], r_dt), r_c)
        t_y, t_c = t_ssm.ssm_decode(tp, t_spec,
                                    torch.from_numpy(x[:, i:i + 1]).to(t_dt),
                                    t_c)
        np.testing.assert_allclose(_np(t_y), _np(r_y), **tol)
        assert str(t_c.conv.dtype).endswith(str(r_c.conv.dtype))
        outs.append(t_y)
    assert t_c.h.dtype == torch.float32
    np.testing.assert_allclose(_np(t_c.h), _np(r_c.h), **tol)
    np.testing.assert_allclose(_np(t_c.conv), _np(r_c.conv), **tol)
    # and the decode agrees with the block over the whole sequence (the
    # reference's own property, test_moe_ssm.py::test_ssm_decode_matches_block)
    full = t_ssm.ssm_block(tp, t_spec, torch.from_numpy(x).to(t_dt))
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full),
                               rtol=0.1, atol=0.05)


def test_ssm_init_matches_the_reference_constants():
    t = t_ssm.SSM(16, t_ssm.SSMSpec(**SSM_SPEC), torch.device("cpu"))
    t.init(torch.Generator().manual_seed(0))
    r = r_ssm.init_ssm(jax.random.PRNGKey(0), 16, r_ssm.SSMSpec(**SSM_SPEC))
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(t.params()[name].detach().numpy(),
                                   np.asarray(r[name]), rtol=1e-6)
    for name, p in t.params().items():
        assert tuple(p.shape) == r[name].shape, name
    assert float(t.conv_w.detach().std()) == pytest.approx(0.1, rel=0.3)


def test_bf16_decode_leaves_the_forward_at_depth_in_both_packages(monkeypatch):
    """The reference's decode-vs-forward property (rtol = atol = 0.15 in
    bfloat16, ``tests/test_models.py``) holds at its 2 reduced layers but
    not at depth: through 96 reduced mamba2 layers the chunked SSD forward
    and the recurrent decode round differently, and the reference's own
    logits leave its tolerance as the port's do.  In float32 the port's two
    paths agree to 1e-3."""
    from dataclasses import replace
    from repro.configs import ARCHS as R_ARCHS
    from repro.models import decode as r_dec
    from repro.models.transformer import LM as RLM
    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.models import decode as t_dec
    from repro_torch.models.transformer import LM as TLM
    from repro_torch.models.transformer import params_from_numpy
    r_cfg = replace(R_ARCHS["mamba2-780m"].reduced(), n_layers=96)
    t_cfg = replace(T_ARCHS["mamba2-780m"].reduced(), n_layers=96)
    r_model = RLM(r_cfg)
    r_params = r_model.init(jax.random.PRNGKey(0))
    t_model = TLM(t_cfg, device="cpu")
    t_model.load_params(params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, r_params), device="cpu"))
    tokens = np.random.default_rng(0).integers(
        0, r_cfg.vocab, (4, 16)).astype(np.int32)

    def outside(dec, full):
        return int((np.abs(dec - full) > 0.15 + 0.15 * np.abs(full)).sum())

    r_full, _ = jax.jit(r_model.forward)(r_params,
                                         {"tokens": jnp.asarray(tokens)})
    step = jax.jit(lambda p, c, t: r_dec.serve_step(r_model, p, c, t))
    cache, r_dec_logits = r_dec.init_cache(r_model, 4, 16), []
    for i in range(16):
        lg, cache = step(r_params, cache, jnp.asarray(tokens[:, i:i + 1]))
        r_dec_logits.append(lg)
    r_gap = outside(_np(jnp.concatenate(r_dec_logits, axis=1)), _np(r_full))

    def port(tb):
        with torch.no_grad():
            full, _ = t_model({"tokens": tb})
        cache, outs = t_dec.init_cache(t_model, 4, 16), []
        for i in range(16):
            lg, cache = t_dec.serve_step(t_model, cache, tb[:, i:i + 1])
            outs.append(lg)
        return _np(torch.cat(outs, dim=1)), _np(full)

    t_dec_logits, t_full = port(torch.from_numpy(tokens))
    assert r_gap > 0 and outside(t_dec_logits, t_full) > 0, r_gap
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    d32, f32 = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(d32, f32, rtol=1e-3, atol=1e-3)
