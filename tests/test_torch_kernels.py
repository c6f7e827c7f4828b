"""repro_torch word-logical kernel glue vs the reference package.

On the CPU the wrappers run the kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode.  Words are integers:
every comparison is exact equality.  The ``cuda`` tests hold the CUDA
kernel against the plain version on the card and skip without one.
"""
import importlib.util
import os
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ewah as r_ewah
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels import word_logical as r_wl
from repro_torch.core import ewah as t_ewah
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import word_logical as t_wl


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


WORD_SHAPES = [(1, 32), (3, 100), (8, 1024), (16, 2048), (20, 1500), (64, 96)]


def _w(a):
    return t_ops.to_device_words(a, "cpu")


def _np(t):
    return t_ops.to_numpy_words(t)


@pytest.mark.parametrize("shape", WORD_SHAPES)
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_word_logical_matches_reference(shape, op):
    rng = np.random.default_rng(zlib.crc32(f"{shape}{op}".encode()))
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    a[0, :] = 0  # clean-zero tiles
    if shape[0] > 2:
        b[2, :] = 0xFFFFFFFF  # clean-one tiles
    a[-1, ::3] |= np.uint32(0x80000000)  # top bit set: the int32 sign
    got = _np(t_ops.word_logical(_w(a), _w(b), op))
    want = np.asarray(r_ops.word_logical(a, b, op))
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, np.asarray(r_ref.word_logical(jnp.asarray(a), jnp.asarray(b), op)))


def test_word_logical_all_clean_tiles():
    a = np.zeros((8, 1024), np.uint32)
    b = np.full((8, 1024), 0xFFFFFFFF, np.uint32)
    assert _np(t_ops.word_logical(_w(a), _w(b), "or")).min() == 0xFFFFFFFF
    assert _np(t_ops.word_logical(_w(a), _w(b), "and")).max() == 0
    assert _np(t_ops.word_logical(_w(b), _w(a), "andnot")).min() == 0xFFFFFFFF


@pytest.mark.parametrize("L", [1, 2, 3, 7, 8, 16])
@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("with_flags", [False, True])
def test_logical_reduce_matches_reference(L, op, with_flags):
    rng = np.random.default_rng(L * 7 + len(op))
    mat = rng.integers(0, 2**32, size=(L, 2500), dtype=np.uint32)
    mat[0, :1100] = 0
    mat[-1, 1024:2048] = 0xFFFFFFFF
    if with_flags:
        # the executor's form: bucketed words with host row flags
        mat = np.pad(mat, ((0, 0), (0, t_ops.bucket_cols(2500) - 2500)))
        rf = t_ops.np_row_flags(mat)
        got = _np(t_ops.logical_reduce(_w(mat), op,
                                       row_flags=torch.from_numpy(rf)))
        want = np.asarray(r_ops.logical_reduce(mat, op=op, row_flags=rf))
    else:
        got = _np(t_ops.logical_reduce(_w(mat), op))
        want = np.asarray(r_ops.logical_reduce(mat, op=op))
    assert np.array_equal(got, want)
    npop = {"and": np.bitwise_and, "or": np.bitwise_or,
            "xor": np.bitwise_xor}[op]
    assert np.array_equal(got, npop.reduce(mat, axis=0))


@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 8, 9, 1000, 1025, 2**20 + 1])
def test_next_pow2_and_bucket_cols_match_reference(x):
    assert t_ops.next_pow2(x) == r_ops.next_pow2(x)
    assert t_ops.bucket_cols(x) == r_ops.bucket_cols(x)
    assert t_ops.bucket_cols(x, 256) == r_ops.bucket_cols(x, 256)


def test_row_and_tile_flags_match_reference():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, size=(16, 4096), dtype=np.uint32)
    w[:8, :1024] = 0
    w[8:, 1024:2048] = 0xFFFFFFFF
    w[3, 2048:3072] = 0           # one clean row in a dirty tile
    w[:, 3072:] = 0xFFFFFFFF
    want_rows = r_ops.np_row_flags(w)
    assert np.array_equal(t_ops.np_row_flags(w), want_rows)
    want_tiles = np.asarray(r_wl.tile_flags(jnp.asarray(w)))
    assert np.array_equal(t_wl.tile_flags(_w(w)).numpy(), want_tiles)
    assert np.array_equal(
        t_ops._combine_row_flags(torch.from_numpy(want_rows)).numpy(),
        r_ops._combine_row_flags(want_rows, 8))


@pytest.mark.parametrize("density", [0.0005, 0.01, 0.3, 0.97, 1.0])
@pytest.mark.parametrize("n_bits", [70_000, 200_000])
def test_container_row_flags_match_reference(density, n_bits):
    rng = np.random.default_rng(int(density * 1e4) + n_bits)
    pos = np.flatnonzero(rng.random(n_bits) < density)
    if density == 1.0:
        pos = np.arange(n_bits)
    elif density > 0.9:
        pos = np.concatenate([np.arange(0, min(65536 * 2, n_bits)), pos])
    r_bm = r_ewah.EWAH.from_positions(np.unique(pos), n_bits,
                                      container="auto")
    t_bm = t_ewah.EWAH.from_positions(np.unique(pos), n_bits,
                                      container="auto")
    assert (r_bm._cont is None) == (t_bm._cont is None)
    cp = t_ops.bucket_cols(t_bm.n_words_uncompressed)
    dense = np.pad(t_bm.to_words(), (0, cp - t_bm.n_words_uncompressed))
    want = r_ops.np_row_flags(dense)
    assert np.array_equal(t_ops.np_row_flags(dense), want)
    if t_bm._cont is not None:
        assert np.array_equal(t_ops.container_row_flags(t_bm._cont, cp),
                              r_ops.container_row_flags(r_bm._cont, cp))
        assert np.array_equal(t_ops.container_row_flags(t_bm._cont, cp),
                              want)


def test_tile_reads_counts_the_operand_tiles_the_result_needs():
    # the smoke script's bytes bound of the kernel
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    D, Z, O = t_wl.DIRTY, t_wl.CLEAN0, t_wl.CLEAN1
    fa = torch.tensor([[D, D, D, Z, O, Z]], dtype=torch.int32)
    fb = torch.tensor([[D, Z, O, D, D, Z]], dtype=torch.int32)
    # and: D&D reads 2; D&Z none; D&O reads a; Z&D none; O&D reads b
    assert smoke.tile_reads(t_wl, fa, fb, "and") == 4
    # or: D|D 2; D|Z a; D|O none; Z|D b; O|D none
    assert smoke.tile_reads(t_wl, fa, fb, "or") == 4
    # xor reads every dirty tile
    assert smoke.tile_reads(t_wl, fa, fb, "xor") == 6
    # andnot a&~b: D,D 2; D,Z a; D,O none; Z,D none; O,D b
    assert smoke.tile_reads(t_wl, fa, fb, "andnot") == 4


def test_wrappers_reject_what_the_kernel_does_not_take():
    a = torch.zeros((8, 1024), dtype=torch.int32)
    f = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        t_ops.word_logical(np.zeros((8, 1024), np.uint32), a)
    with pytest.raises(TypeError):
        t_wl.word_logical(a.to(torch.int64), a.to(torch.int64), f, f)
    with pytest.raises(ValueError):
        t_wl.word_logical(a[:, :1000], a[:, :1000], f, f)
    with pytest.raises(ValueError):
        t_wl.word_logical(a, a, f, f, op="nand")
    with pytest.raises(ValueError):
        t_ops.logical_reduce(a, op="andnot")


def test_plain_version_runs_for_cpu_tensors_without_launching():
    before = t_wl.launches
    a = torch.full((8, 1024), -1, dtype=torch.int32)
    f = t_wl.tile_flags(a)
    out = t_wl.word_logical(a, a, f, f, "xor")
    assert int(out.abs().sum()) == 0
    assert t_wl.launches == before


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        assert t_ops.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_ops.resolve_device("cuda")
    assert t_ops.resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the word_logical kernel runs only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_cuda_kernel_matches_plain(cuda_device, op):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, size=(16, 8192), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(16, 8192), dtype=np.uint32)
    a[:8, :2048] = 0
    b[8:, 2048:4096] = 0xFFFFFFFF
    a[:, 6144:] = 0xFFFFFFFF
    ta = t_ops.to_device_words(a, cuda_device)
    tb = t_ops.to_device_words(b, cuda_device)
    fa, fb = t_wl.tile_flags(ta), t_wl.tile_flags(tb)
    before = t_wl.launches
    got = t_wl.word_logical(ta, tb, fa, fb, op)
    torch.cuda.synchronize()
    assert t_wl.launches == before + 1
    want = t_wl.word_logical_plain(ta, tb, fa, fb, op)
    assert torch.equal(got, want)
    assert np.array_equal(t_ops.to_numpy_words(got),
                          np.asarray(r_ref.word_logical(
                              jnp.asarray(a), jnp.asarray(b), op)))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 3, 8, 64])
def test_cuda_logical_reduce_matches_numpy(cuda_device, L):
    rng = np.random.default_rng(L)
    mat = rng.integers(0, 2**32, size=(L, 5000), dtype=np.uint32)
    mat[0, :3000] = 0
    for op, npop in (("and", np.bitwise_and), ("or", np.bitwise_or),
                     ("xor", np.bitwise_xor)):
        got = t_ops.logical_reduce(t_ops.to_device_words(mat, cuda_device),
                                   op)
        assert np.array_equal(t_ops.to_numpy_words(got),
                              npop.reduce(mat, axis=0))


def test_build_is_keyed_on_the_source_and_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    path = _build.library_path("word_logical")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("word_logical-") and path.suffix == ".so"
    assert _build.library_path("word_logical") == path
    src = tmp_path / "word_logical.cu"
    src.write_text((_build.CSRC / "word_logical.cu").read_text() + "\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path("word_logical") != path
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()
