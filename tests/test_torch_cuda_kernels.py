"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bitpack import pack_matrix
from repro_torch.kernels import bitpack_kernel as t_bp
from repro_torch.kernels import grad_compress as t_kgc
from repro_torch.kernels import logical_reduce as t_lr
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import popcount as t_pc
from repro_torch.kernels import word_logical as t_wl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 256 * 100, 256 * 100 + 17, 256 * 20001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_block_sqnorms_matches_plain(cuda_device, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    g = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    before = t_kgc.launches
    got = t_ops.block_sqnorms(g)
    torch.cuda.synchronize()
    assert t_kgc.launches == before + 1
    gp = torch.nn.functional.pad(g.float(), (0, -n % 256))
    want = t_kgc.block_sqnorms_plain(gp)
    # float32 sums of 256 positive squares in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    mask = t_ops.topk_block_mask(g, 0.25)
    assert mask.device.type == "cuda" and mask.dtype == torch.bool
    assert int(mask.sum()) >= max(int(got.numel() * 0.25), 1)


@pytest.mark.cuda
def test_block_sqnorms_rejects_other_block_widths(cuda_device):
    with pytest.raises(ValueError, match="256"):
        t_ops.block_sqnorms(torch.ones(512, device=cuda_device), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_word_logical_matches_plain_and_numpy(cuda_device, op):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, size=(16, 8192), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(16, 8192), dtype=np.uint32)
    a[:8, :2048] = 0
    b[8:, 2048:4096] = 0xFFFFFFFF
    ta = t_ops.to_device_words(a, cuda_device)
    tb = t_ops.to_device_words(b, cuda_device)
    fa, fb = t_wl.tile_flags(ta), t_wl.tile_flags(tb)
    got = t_wl.word_logical(ta, tb, fa, fb, op)
    torch.cuda.synchronize()
    assert torch.equal(got, t_wl.word_logical_plain(ta, tb, fa, fb, op))
    want = {"and": a & b, "or": a | b, "xor": a ^ b, "andnot": a & ~b}[op]
    assert np.array_equal(t_ops.to_numpy_words(got), want)


def _reduce_words(L, C, seed):
    """(L, C) uint32 words: each 1024-word block of each row random (top
    bits set on a third of its words), all zeros or all ones; block 0 of
    row 0 absorbs an AND, the last block of the last row an OR."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2**32, size=(L, C), dtype=np.uint32)
    m[:, ::3] |= np.uint32(0x80000000)
    nb = -(-C // 1024)
    kind = np.repeat(rng.random((L, nb)), 1024, axis=1)[:, :C]
    m[kind < 0.12] = 0
    m[(kind >= 0.12) & (kind < 0.24)] = 0xFFFFFFFF
    m[0, :1024] = 0
    m[-1, -1024:] = 0xFFFFFFFF
    return m


def _reduce_flags(m, kind, seed):
    """Flag rows of ``m`` (the executor's form: ``np_row_flags`` of the
    rows zero-padded to whole blocks), with 40% of them DIRTY when
    conservative; None when absent."""
    if kind == "absent":
        return [None] * len(m)
    C = m.shape[1]
    rf = t_ops.np_row_flags(np.pad(m, ((0, 0), (0, -C % 1024))))
    if kind == "conservative":
        rng = np.random.default_rng(seed)
        rf = np.where(rng.random(rf.shape) < 0.4, t_wl.DIRTY, rf)
    return list(torch.from_numpy(rf.astype(np.int32)).unbind(0))


def _check_fold(rows, flags, neg, neg_flags, op, want):
    """One fused call on the card: ceil(rows / MAX_ROWS) launches, words
    equal to the plain version (on the CPU) and to ``want``, and an exact
    flag row of the result."""
    dev = rows[0].device
    before = t_lr.launches
    out, out_flags = t_lr.fold(
        rows, [f if f is None else f.to(dev) for f in flags], neg,
        [f if f is None else f.to(dev) for f in neg_flags], op)
    torch.cuda.synchronize()
    assert t_lr.launches == before + -(-(len(rows) + len(neg))
                                       // t_lr.MAX_ROWS)
    plain, plain_flags = t_lr.fold([r.cpu() for r in rows], flags,
                                   [r.cpu() for r in neg], neg_flags, op)
    assert torch.equal(out.cpu(), plain)
    assert torch.equal(out_flags.cpu(), plain_flags)
    got = t_ops.to_numpy_words(out)
    assert np.array_equal(got, want)
    C = len(got)
    assert np.array_equal(out_flags.cpu().numpy(), t_lr.row_flags(
        out.cpu()[None])[0].numpy())
    if C % 1024 == 0:
        assert np.array_equal(out_flags.cpu().numpy(),
                              t_ops.np_row_flags(got))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["exact", "conservative", "absent"])
@pytest.mark.parametrize("C", [1024, 2049, 65536, 131072])
@pytest.mark.parametrize("L", [2, 3, 8, 64, 100, 300])
def test_logical_reduce_matches_plain_and_numpy(cuda_device, L, C, flags):
    m = _reduce_words(L, C, L * C)
    fl = _reduce_flags(m, flags, L + C)
    rows = list(t_ops.to_device_words(m, cuda_device).unbind(0))
    for op, npop in (("and", np.bitwise_and), ("or", np.bitwise_or),
                     ("xor", np.bitwise_xor)):
        want = npop.reduce(m, axis=0)
        _check_fold(rows, fl, [], [], op, want)
        mat = t_ops.to_device_words(m, cuda_device)
        got = t_ops.logical_reduce(mat, op, row_flags=None if fl[0] is None
                                   else torch.stack(fl).to(cuda_device))
        assert np.array_equal(t_ops.to_numpy_words(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["exact", "conservative", "absent"])
@pytest.mark.parametrize("C", [2049, 65536])
@pytest.mark.parametrize("n_pos,n_neg", [(1, 1), (2, 1), (40, 100),
                                         (3, 200)])
def test_diff_reduce_matches_plain_and_numpy(cuda_device, n_pos, n_neg, C,
                                             flags):
    m = _reduce_words(n_pos + n_neg, C, n_pos * 1000 + n_neg)
    # dense pos rows, so the AND does not absorb everywhere
    m[:n_pos] |= np.uint32(0xFFF7FFBF)
    m[0, :1024] = 0
    fl = _reduce_flags(m, flags, C)
    rows = list(t_ops.to_device_words(m, cuda_device).unbind(0))
    want = np.bitwise_and.reduce(m[:n_pos], axis=0) \
        & ~np.bitwise_or.reduce(m[n_pos:], axis=0)
    _check_fold(rows[:n_pos], fl[:n_pos], rows[n_pos:], fl[n_pos:], "and",
                want)
    dev_fl = [f if f is None else f.to(cuda_device) for f in fl]
    got = t_ops.diff_reduce(rows[:n_pos], dev_fl[:n_pos], rows[n_pos:],
                            dev_fl[n_pos:])
    assert np.array_equal(t_ops.to_numpy_words(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,cols", [(1, 1024), (3, 2048), (0, 1026),
                                         (2, 65536)])
def test_logical_reduce_of_unaligned_rows(cuda_device, offset, cols):
    # views that start off a 16-byte boundary, or rows of a width that is
    # not a multiple of 4 words: the kernel's 4-byte load form
    L = 70
    m = _reduce_words(L, cols + 4, cols)
    buf = t_ops.to_device_words(m, cuda_device)
    rows = [buf[i, offset:offset + cols] for i in range(L)]
    assert rows[1].data_ptr() % 16 or cols % 4
    sub = m[:, offset:offset + cols]
    fl = _reduce_flags(sub, "exact", cols)
    for op, npop in (("and", np.bitwise_and), ("or", np.bitwise_or),
                     ("xor", np.bitwise_xor)):
        _check_fold(rows, fl, [], [], op, npop.reduce(sub, axis=0))
    _check_fold(rows[:30], fl[:30], rows[30:], fl[30:], "and",
                np.bitwise_and.reduce(sub[:30], axis=0)
                & ~np.bitwise_or.reduce(sub[30:], axis=0))


# the reference's shapes, then the smoke's index matrix (1,500 bitmaps of
# 131,072 words)
POPCOUNT_SHAPES = [(1, 5), (8, 1024), (5, 333), (17, 2049), (1500, 131072)]


def _random_words(device, shape, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    a = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                      device=device, generator=gen)
    a[0] = 0
    a[-1, ::3] = -1
    return a


def _check_popcount(a):
    before = dict(t_pc.launches)
    total = t_ops.popcount_total(a)
    rows = t_ops.popcount_rows(a)
    torch.cuda.synchronize()
    assert t_pc.launches == {"popcount_total": before["popcount_total"] + 1,
                             "popcount_rows": before["popcount_rows"] + 1}
    assert total.dtype == torch.int32 and total.dim() == 0
    assert rows.dtype == torch.int32 and rows.shape == (a.shape[0],)
    assert torch.equal(total, t_pc.popcount_total_plain(a))
    assert torch.equal(rows, t_pc.popcount_rows_plain(a))
    return total, rows


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POPCOUNT_SHAPES)
def test_popcount_matches_plain_and_numpy(cuda_device, shape):
    a = _random_words(cuda_device, shape, shape[0] * shape[1])
    total, rows = _check_popcount(a)
    if a.numel() <= 1 << 20:
        host = t_ops.to_numpy_words(a)
        want = np.bitwise_count(host).sum(1)
        assert np.array_equal(rows.cpu().numpy(), want)
        assert int(total) == int(want.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("offset,cols", [(1, 1024), (3, 1024), (1, 2049),
                                         (4, 1026)])
def test_popcount_of_unaligned_rows_matches_plain(cuda_device, offset, cols):
    # a view that starts off a 16-byte boundary, or rows of a width that is
    # not a multiple of 4 words: the kernels' 4-byte load paths
    buf = _random_words(cuda_device, (10, cols), cols).view(-1)
    a = buf[offset:offset + 9 * cols].view(9, cols)
    assert a.data_ptr() % 16 or cols % 4
    _check_popcount(a)


@pytest.mark.cuda
def test_popcount_wraps_like_the_reference_int32_sum(cuda_device):
    # 2^31 set bits: -2^31 in int32, the reference's wrap
    ones = torch.full((8, 1 << 23), -1, dtype=torch.int32,
                      device=cuda_device)
    total, rows = _check_popcount(ones)
    assert int(total) == -2**31
    assert rows.tolist() == [1 << 28] * 8
    del ones
    # one row of 2^26 all-ones words wraps too
    ones = torch.full((2, 1 << 26), -1, dtype=torch.int32,
                      device=cuda_device)
    total, rows = _check_popcount(ones)
    assert rows.tolist() == [-2**31, -2**31] and int(total) == 0


@pytest.mark.cuda
def test_popcount_of_empty_matrices_launches_nothing(cuda_device):
    before = dict(t_pc.launches)
    for shape in ((0, 5), (3, 0)):
        t = torch.zeros(shape, dtype=torch.int32, device=cuda_device)
        assert int(t_ops.popcount_total(t)) == 0
        assert t_ops.popcount_rows(t).tolist() == [0] * shape[0]
    assert t_pc.launches == before


# the reference's (N, L) grid, ragged N, L = 1, a grid taller than 65,535
# word rows, and 2^20 rows of the smoke's 1,500 bitmaps
BITPACK_SHAPES = [(32, 4), (1024, 128), (2048, 200), (96, 7), (4096, 64),
                  (33, 9), (1000, 130), (256, 1), (4_194_309, 3),
                  (1 << 20, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,L", BITPACK_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_bitpack_matches_plain_and_pack_matrix(cuda_device, N, L, density):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(N * L)
    bits = torch.rand((N, L), generator=gen, device=cuda_device) < density
    before = t_bp.launches
    got = t_ops.bitpack(bits)
    torch.cuda.synchronize()
    assert t_bp.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (-(-N // 32), L)
    assert torch.equal(got, t_bp.bitpack_plain(bits))
    if N * L <= 1 << 20:
        assert np.array_equal(t_ops.to_numpy_words(got).T,
                              pack_matrix(bits.cpu().numpy()))


@pytest.mark.cuda
def test_bitpack_reads_other_dtypes_as_nonzero(cuda_device):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    x = torch.randint(0, 3, (1000, 37), dtype=torch.uint8, device=cuda_device,
                      generator=gen)
    x[::7] = 255
    assert torch.equal(t_ops.bitpack(x), t_bp.bitpack_plain(x != 0))


@pytest.mark.cuda
@pytest.mark.parametrize("serve_kwargs", [{}, {"backend": "kernel"}],
                         ids=["defaults", "kernel"])
def test_served_store_defaults_run_logical_reduce_on_the_card(
        cuda_device, tmp_path, serve_kwargs):
    """``Dataset.open(dir).serve()`` of a sharded store fans its shards out
    on threads on the card (a forked process pool would run host EWAH) and
    its statements launch the fused kernel."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import Dataset
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 16, size=(1 << 16, 2))
    Dataset.from_rows(rows, ["c0", "c1"], sort="none", shards=4,
                      device="cpu").save(str(tmp_path / "store"))
    svc = Dataset.open(str(tmp_path / "store")).serve(**serve_kwargs)
    try:
        assert svc.device.type == "cuda"
        assert isinstance(svc._shard_pool, ThreadPoolExecutor)
        where = {"op": "and", "args": [
            {"op": "in", "col": "c0", "values": [1, 2, 3, 4, 5]},
            {"op": "in", "col": "c1", "values": [0, 7, 9]}]}
        mask = np.isin(rows[:, 0], [1, 2, 3, 4, 5]) & \
            np.isin(rows[:, 1], [0, 7, 9])
        before = t_lr.launches
        got = svc.statement({"select": {"count": True}, "where": where})
        assert t_lr.launches > before
        assert got["count"] == int(mask.sum())
        groups = svc.statement({"select": {"group_count": "c1"},
                                "where": where})
        assert list(groups["counts"]) == \
            np.bincount(rows[mask, 1], minlength=16).tolist()
    finally:
        svc.close()
