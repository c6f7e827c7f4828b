"""repro_torch gradient compression vs the reference package.

``block_sqnorms`` on a CPU tensor runs the kernel's plain PyTorch version;
the reference runs its Pallas kernel in interpret mode and its pure-jnp
oracle.  Sums of squares are float32 sums taken in another order, so they
are compared at rtol=2e-3 (the reference's own kernel-vs-oracle tolerance);
masks, which only depend on the order of well-separated norms, and the
compression stats, which are integers, are compared exactly.  The CUDA
kernel is held against the plain version on the card in
``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import grad_compression as r_gc
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.distributed import grad_compression as t_gc
from repro_torch.kernels import grad_compress as t_kgc
from repro_torch.kernels import ops as t_ops


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(1)


@pytest.mark.parametrize("n", [256, 256 * 100, 256 * 100 + 17])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_block_sqnorms_matches_reference(n, dtype):
    g = RNG.standard_normal(n).astype(dtype)
    got = t_ops.block_sqnorms(torch.from_numpy(g)).numpy()
    pad = (-len(g)) % 256
    gp = np.pad(g.astype(np.float32), (0, pad))
    kernel = np.asarray(r_ops.block_sqnorms(g))
    oracle = np.asarray(r_ref.block_sqnorms(jnp.asarray(gp), 256))
    assert got.dtype == np.float32 and got.shape == (len(gp) // 256,)
    np.testing.assert_allclose(got, kernel, rtol=2e-3)
    np.testing.assert_allclose(got, oracle, rtol=2e-3)
    np.testing.assert_allclose(
        got, t_kgc.block_sqnorms_plain(torch.from_numpy(gp)).numpy(),
        rtol=0)


def test_block_sqnorms_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="1-D"):
        t_ops.block_sqnorms(torch.zeros(2, 256))
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.block_sqnorms(torch.zeros(1024)[::2])
    with pytest.raises(TypeError):
        t_ops.block_sqnorms(np.zeros(256, np.float32))


def test_block_sqnorms_cpu_never_launches():
    before = t_kgc.launches
    t_ops.block_sqnorms(torch.ones(512))
    assert t_kgc.launches == before


def test_topk_block_mask_one_hot_block():
    g = np.zeros(256 * 10, np.float32)
    g[256 * 3: 256 * 4] = 100.0  # one hot block
    got = t_ops.topk_block_mask(torch.from_numpy(g), 0.1).numpy()
    want = np.asarray(r_ops.topk_block_mask(g, 0.1))
    assert got[3] and got.sum() == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep", [0.05, 0.25, 0.5, 1.0])
def test_topk_block_mask_separated_norms(keep):
    # block b has every value equal to b + 1: norms 256 (b + 1)^2 are far
    # apart, so the k-th and (k+1)-th never straddle a rounding error
    n_blocks = 40
    g = np.repeat(np.arange(1, n_blocks + 1, dtype=np.float32), 256)
    perm = RNG.permutation(n_blocks)
    g = g.reshape(n_blocks, 256)[perm].reshape(-1)
    got = t_ops.topk_block_mask(torch.from_numpy(g), keep).numpy()
    want = np.asarray(r_ops.topk_block_mask(g, keep))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == max(int(n_blocks * keep), 1)


def test_topk_block_mask_keeps_ties():
    g = np.ones(256 * 8, np.float32)   # eight equal norms
    got = t_ops.topk_block_mask(torch.from_numpy(g), 0.25).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        r_ops.topk_block_mask(g, 0.25)))
    assert got.all()


def _grads(seed):
    rng = np.random.default_rng(seed)
    # leaf sizes that straddle block boundaries, with energy that varies by
    # orders of magnitude from leaf to leaf
    return {"a": (rng.standard_normal((7, 100)) * 10).astype(np.float32),
            "b": (rng.standard_normal(300) * 0.1).astype(np.float32),
            "c": rng.standard_normal((3, 5, 61)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("keep", [0.1, 0.3, 1.0])
def test_sparsify_matches_reference(keep):
    g = _grads(2)
    err = {k: v * 0.05 for k, v in _grads(3).items()}
    r_kept, r_err, r_mask, r_flat = r_gc.sparsify(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in err.items()}, keep)
    t_kept, t_err, t_mask, t_flat = t_gc.sparsify(_t(g), _t(err), keep)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(r_mask))
    np.testing.assert_allclose(t_flat.numpy(), np.asarray(r_flat), rtol=1e-6)
    np.testing.assert_allclose(t_kept.numpy(), np.asarray(r_kept), rtol=1e-6)
    np.testing.assert_allclose(t_err.numpy(), np.asarray(r_err), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("keep", [0.1, 0.5])
def test_compressed_allreduce_matches_reference(keep):
    g = _grads(4)
    r_out, r_err, r_stats = r_gc.compressed_allreduce(
        {k: jnp.asarray(v) for k, v in g.items()},
        r_gc.init_error({k: jnp.asarray(v) for k, v in g.items()}), keep)
    t_out, t_err, t_stats = t_gc.compressed_allreduce(
        _t(g), t_gc.init_error(_t(g)), keep)
    assert tuple(t_stats) == tuple(r_stats)
    assert t_stats.ratio == r_stats.ratio
    for k in g:
        assert t_out[k].shape == tuple(r_out[k].shape)
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(r_out[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(t_err[k].numpy(), np.asarray(r_err[k]),
                                   rtol=1e-6)


def test_unflatten_restores_shapes_and_dtypes():
    tree = {"w": torch.zeros(3, 4), "h": torch.zeros(5, dtype=torch.float16)}
    flat = torch.arange(17, dtype=torch.float32)
    out = t_gc._unflatten(tree, flat)
    assert out["w"].shape == (3, 4) and out["h"].dtype == torch.float16
    assert torch.equal(t_gc._flatten(out)[0], flat)


# -- ports of tests/test_distributed.py's gradient-compression tests ---------

def test_sparsify_identity_at_full_keep():
    grads = {"a": torch.arange(512.0), "b": torch.ones(256)}
    err = t_gc.init_error(grads)
    out, new_err, stats = t_gc.compressed_allreduce(grads, err,
                                                    keep_ratio=1.0)
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), grads[k].numpy())
    assert max(float(v.abs().max()) for v in new_err.values()) == 0


def test_error_feedback_accumulates_dropped_mass():
    grads = {"w": torch.cat([torch.full((256,), 10.0),
                             torch.full((256,), 0.1)])}
    err = t_gc.init_error(grads)
    out, err, stats = t_gc.compressed_allreduce(grads, err, keep_ratio=0.5)
    # big block kept, small block dropped into error feedback
    assert float(out["w"][:256].sum()) > 0
    assert float(out["w"][256:].sum()) == 0
    np.testing.assert_allclose(err["w"][256:].numpy(), 0.1, rtol=1e-6)
    # next round: error feedback makes the dropped block win eventually
    out2, err2, _ = t_gc.compressed_allreduce(
        {"w": torch.zeros(512)}, err, keep_ratio=0.5)
    assert float(out2["w"][256:].abs().sum()) > 0


def test_compression_ratio_reported():
    w = torch.zeros(256 * 64)
    w[0] = 1.0
    g = {"w": w}
    _, _, stats = t_gc.compressed_allreduce(g, t_gc.init_error(g), 1 / 64)
    assert stats.ratio > 10
    assert stats.bitmap_words < 16
