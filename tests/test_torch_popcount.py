"""repro_torch popcount kernels vs the reference package.

On the CPU the wrappers run the kernels' plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode.  Counts are integers:
every comparison is exact equality.  The card tests are in the JAX-free
``tests/test_torch_cuda_kernels.py``.
"""
import zlib

import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.core import synth as t_synth
from repro_torch.core.index import BitmapIndex
from repro_torch.kernels import _build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import popcount as t_pc

# the reference's own shapes (tests/test_kernels.py) and added edge cases
SHAPES = [(1, 5), (8, 1024), (5, 333), (17, 2049), (1, 1), (40, 3)]


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep these tests from starving other files' timing-sensitive
    tests of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _words(shape, fill):
    rng = np.random.default_rng(zlib.crc32(f"{shape}{fill}".encode()))
    if fill == "zeros":
        return np.zeros(shape, np.uint32)
    if fill == "ones":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    if fill == "top_bit":  # the int32 sign bit set in every word
        a |= np.uint32(0x80000000)
    if fill == "sparse":  # words of a 2% dense bitmap
        bits = rng.random((shape[0], shape[1] * 32)) < 0.02
        a = np.packbits(bits, axis=1, bitorder="little").view("<u4")
        a = a.astype(np.uint32).reshape(shape)
    return a


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fill", ["random", "top_bit", "sparse", "zeros",
                                  "ones"])
def test_popcount_matches_reference(shape, fill):
    a = _words(shape, fill)
    t = t_ops.to_device_words(a, "cpu")
    got_total = t_ops.popcount_total(t)
    want_total = np.asarray(r_ops.popcount_total(a))
    assert got_total.dtype == torch.int32 and got_total.dim() == 0
    assert want_total.dtype == np.int32 and want_total.shape == ()
    assert int(got_total) == int(want_total)
    got_rows = t_ops.popcount_rows(t)
    want_rows = np.asarray(r_ops.popcount_rows(a))
    assert got_rows.dtype == torch.int32
    assert np.array_equal(got_rows.numpy(), want_rows)
    assert want_rows.dtype == np.int32
    assert int(got_total) == int(np.bitwise_count(a).sum())


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("container", ["run", "auto"])
def test_popcount_rows_of_index_words_equal_bitmap_count(k, container):
    rng = np.random.default_rng(k)
    table, _ = t_synth.factorize(t_synth.uniform_table(5000, 3, r=2,
                                                       rng=rng))
    index = BitmapIndex.build(table, k=k, container=container)
    words = np.stack([index.bitmap(c, b).to_words()
                      for c, ci in enumerate(index.columns)
                      for b in range(ci.encoder.L)])
    counts = [ci.bitmap_count(b) for ci in index.columns
              for b in range(ci.encoder.L)]
    t = t_ops.to_device_words(words, "cpu")
    assert t_ops.popcount_rows(t).tolist() == counts
    assert np.array_equal(np.asarray(r_ops.popcount_rows(words)), counts)
    # every row sets k_c bits in column c
    want = sum(ci.encoder.k for ci in index.columns) * index.n_rows
    assert int(t_ops.popcount_total(t)) == want == sum(counts)


def test_popcount_total_wraps_like_the_reference_int32_sum():
    # 2^26 all-ones words hold 2^31 set bits: -2^31 in int32, as the
    # reference's int32 sum of its tile partials gives.  An expanded view
    # keeps the input small; the plain version widens it a row at a time.
    ones = torch.full((1, 1), -1, dtype=torch.int32).expand(8, 1 << 23)
    total = t_pc.popcount_total(ones)
    assert total.dtype == torch.int32 and int(total) == -2**31


@pytest.mark.parametrize("shape", [(0, 5), (3, 0), (0, 0)])
def test_popcount_of_empty_matrices(shape):
    t = torch.zeros(shape, dtype=torch.int32)
    assert int(t_ops.popcount_total(t)) == 0
    assert t_ops.popcount_rows(t).tolist() == [0] * shape[0]


def test_popcount_accepts_non_contiguous_views():
    a = _words((6, 40), "random")
    t = t_ops.to_device_words(a, "cpu")
    view = t[:, ::2]
    assert not view.is_contiguous()
    assert np.array_equal(t_ops.popcount_rows(view).numpy(),
                          np.bitwise_count(a[:, ::2]).sum(1))
    assert int(t_ops.popcount_total(view)) == \
        int(np.bitwise_count(a[:, ::2]).sum())


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    before = dict(t_pc.launches)
    t = t_ops.to_device_words(_words((17, 2049), "random"), "cpu")
    t_ops.popcount_total(t)
    t_ops.popcount_rows(t)
    assert t_pc.launches == before


@pytest.mark.parametrize("bad", [
    np.zeros((2, 3), np.uint32),                  # not a tensor
    torch.zeros((2, 3), dtype=torch.int64),       # wrong dtype
    torch.zeros((2, 3), dtype=torch.uint8),
    torch.zeros(6, dtype=torch.int32),            # wrong rank
    torch.zeros((1, 2, 3), dtype=torch.int32),
])
@pytest.mark.parametrize("fn", ["popcount_total", "popcount_rows"])
def test_popcount_rejects_what_the_kernel_does_not_take(bad, fn):
    with pytest.raises(TypeError):
        getattr(t_ops, fn)(bad)
