"""repro_torch bitpack kernel vs the reference package.

On the CPU the wrapper runs the kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode.  Words are integers:
every comparison is exact equality.  The card tests are in the JAX-free
``tests/test_torch_cuda_kernels.py``.
"""
import importlib.util
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.core import Dataset, synth as t_synth
from repro_torch.core.bitpack import pack_matrix
from repro_torch.kernels import _build
from repro_torch.kernels import bitpack_kernel as t_bp
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import popcount as t_pc

# the reference's own (N, L) grid (tests/test_kernels.py), then N not a
# multiple of 32 and L = 1
SHAPES = [(32, 4), (1024, 128), (2048, 200), (96, 7), (4096, 64),
          (33, 9), (1000, 130), (256, 1), (33, 1)]


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep these tests from starving other files' timing-sensitive
    tests of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bits(shape, density):
    rng = np.random.default_rng(zlib.crc32(f"{shape}{density}".encode()))
    return rng.random(shape) < density


@pytest.mark.parametrize("N,L", SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_bitpack_matches_reference(N, L, density):
    bits = _bits((N, L), density)
    got = t_ops.bitpack(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.shape == (-(-N // 32), L)
    got = t_ops.to_numpy_words(got)
    want = np.asarray(r_ops.bitpack(bits))
    assert want.shape == got.shape
    assert np.array_equal(got, want)
    # bit i of word w is row 32w+i: the host codec's convention
    assert np.array_equal(got.T, pack_matrix(bits))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_bitpack_reads_other_dtypes_as_nonzero(dtype):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, size=(100, 5)).astype(dtype)
    x[::7] = 255 if dtype == np.uint8 else -1
    got = t_ops.to_numpy_words(t_ops.bitpack(torch.from_numpy(x)))
    assert np.array_equal(got, np.asarray(r_ops.bitpack(x)))
    assert np.array_equal(got.T, pack_matrix(x != 0))


def test_bitpack_takes_non_contiguous_views_and_empty_inputs():
    bits = _bits((70, 12), 0.5)
    t = torch.from_numpy(bits)
    got = t_ops.to_numpy_words(t_ops.bitpack(t[:, ::3]))
    assert np.array_equal(got, np.asarray(r_ops.bitpack(bits[:, ::3])))
    assert t_ops.bitpack(torch.zeros((0, 4), dtype=torch.bool)).shape == (0, 4)
    assert t_ops.bitpack(torch.zeros((40, 0), dtype=torch.bool)).shape == (2, 0)


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    before = t_bp.launches
    t_ops.bitpack(torch.from_numpy(_bits((96, 7), 0.5)))
    t_ops.bitpack(torch.from_numpy(_bits((33, 1), 0.5)))
    assert t_bp.launches == before


@pytest.mark.parametrize("bad,exc", [
    (np.zeros((32, 3), bool), TypeError),               # not a tensor
    (torch.zeros(32, dtype=torch.bool), ValueError),     # wrong rank
    (torch.zeros((1, 32, 3), dtype=torch.bool), ValueError),
])
def test_bitpack_rejects_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        t_ops.bitpack(bad)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("sort", ["lex", "none"])
@pytest.mark.parametrize("k", [1, 2])
def test_smoke_index_profile_on_a_small_table(sort, k):
    # the smoke's index-profile phase at a tiny size, on the CPU: the
    # bools it scatters from the rows pack into the index's own bitmaps
    smoke = _smoke()
    rng = np.random.default_rng(3)
    table, _ = t_synth.factorize(t_synth.uniform_table(3000, 4, r=2,
                                                       rng=rng))
    ds = Dataset.from_rows(table, smoke.NAMES, sort=sort, k=k, device="cpu")
    bits, words, launches, errs = smoke.index_profile_run(
        torch, t_ops, t_pc, t_bp, ds, "cpu")
    assert bits.shape == (ds.n_rows, ds.index.n_bitmaps)
    assert words.shape == (ds.index.n_bitmaps, -(-ds.n_rows // 32))
    assert launches == {"bitpack": 0, "popcount_rows": 0,
                        "popcount_total": 0}
    assert errs == {"bitpack": 0, "popcount_rows": 0, "popcount_total": 0}
    want = np.stack([ds.index.bitmap(c, b).to_words()
                     for c, ci in enumerate(ds.index.columns)
                     for b in range(ci.encoder.L)])
    assert np.array_equal(np.asarray(r_ops.bitpack(bits.numpy())).T, want)
