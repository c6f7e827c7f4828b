"""repro_torch's fused n-ary ``logical_reduce`` and ``diff_reduce`` vs the
reference package.

On the CPU each launch of the fused kernel takes its plain PyTorch version,
through the same chained launch plan (one launch per ``MAX_ROWS`` rows);
the reference runs its pairwise Pallas kernel in interpret mode, as a tree.
Words come from a NumPy seed with top-bit words, whole clean-0 / clean-1
blocks and absorbing blocks; flags are exact, conservative (some clean
blocks marked DIRTY) or absent.  Every comparison is exact equality.
"""
import importlib.util
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core import synth
from repro.core.expr import col as r_col
from repro.kernels import ops as r_ops
from repro_torch.core import dataset as t_dataset
from repro_torch.core.expr import col as t_col
from repro_torch.kernels import logical_reduce as t_lr
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


NP_OPS = {"and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor}
FLAG_KINDS = ["exact", "conservative", "absent"]


def _w(a):
    return t_ops.to_device_words(a, "cpu")


def _np(t):
    return t_ops.to_numpy_words(t)


def _words(L, C, seed):
    """(L, C) uint32 words: each 1024-word block of each row random (top
    bits set on a third of its words), all zeros or all ones."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2**32, size=(L, C), dtype=np.uint32)
    m[:, ::3] |= np.uint32(0x80000000)
    for r in range(L):
        for b in range(-(-C // 1024)):
            kind = rng.random()
            if kind < 0.12:
                m[r, b * 1024:(b + 1) * 1024] = 0
            elif kind < 0.24:
                m[r, b * 1024:(b + 1) * 1024] = 0xFFFFFFFF
    m[0, :1024] = 0                  # absorbs an AND in block 0
    m[-1, -1024:] = 0xFFFFFFFF       # absorbs an OR in the last block
    return m


def _flags(m, kind, seed):
    """Row flags for the bucketed words, in the executor's form
    (``np_row_flags`` of the zero-padded rows), or None."""
    if kind == "absent":
        return None
    cp = t_ops.bucket_cols(m.shape[1])
    rf = t_ops.np_row_flags(np.pad(m, ((0, 0), (0, cp - m.shape[1]))))
    if kind == "conservative":
        rng = np.random.default_rng(seed)
        rf = np.where(rng.random(rf.shape) < 0.4, t_wl.DIRTY, rf)
    return rf.astype(np.int32)


@pytest.mark.parametrize("flags", FLAG_KINDS)
@pytest.mark.parametrize("C", [1000, 1024, 2049, 4096])
@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 7, 8, 16, 40, 100, 129])
def test_logical_reduce_matches_reference(L, op, C, flags):
    seed = zlib.crc32(f"{L}{op}{C}{flags}".encode())
    m = _words(L, C, seed)
    rf = _flags(m, flags, seed + 1)
    got = t_ops.logical_reduce(
        _w(m), op, row_flags=None if rf is None else torch.from_numpy(rf))
    want = np.asarray(r_ops.logical_reduce(m, op=op, row_flags=rf))
    assert np.array_equal(_np(got), want)
    assert np.array_equal(want, NP_OPS[op].reduce(m, axis=0))


@pytest.mark.parametrize("flags", FLAG_KINDS)
@pytest.mark.parametrize("C", [1000, 4096])
@pytest.mark.parametrize("n_pos,n_neg", [(1, 1), (2, 1), (5, 3), (100, 40)])
def test_diff_reduce_matches_reference_composition(n_pos, n_neg, C, flags):
    seed = zlib.crc32(f"{n_pos}/{n_neg}{C}{flags}".encode())
    m = _words(n_pos + n_neg, C, seed)
    # dense pos rows, so the AND does not absorb everywhere
    m[:n_pos] |= np.random.default_rng(seed).integers(
        0, 2**32, size=(n_pos, C), dtype=np.uint32) | np.uint32(0x7FFF7FFF)
    m[0, :1024] = 0
    rf = _flags(m, flags, seed + 1)
    pos, neg = m[:n_pos], m[n_pos:]
    rows = list(_w(m).unbind(0))
    fl = [None] * len(rows) if rf is None else \
        list(torch.from_numpy(rf).unbind(0))
    got = _np(t_ops.diff_reduce(rows[:n_pos], fl[:n_pos], rows[n_pos:],
                                fl[n_pos:]))
    a = r_ops.logical_reduce(pos, "and",
                             row_flags=None if rf is None else rf[:n_pos])
    b = r_ops.logical_reduce(neg, "or",
                             row_flags=None if rf is None else rf[n_pos:])
    want = np.asarray(r_ops.word_logical(np.asarray(a)[None],
                                         np.asarray(b)[None], "andnot"))[0]
    assert np.array_equal(got, want)
    assert np.array_equal(want, np.bitwise_and.reduce(pos, axis=0)
                          & ~np.bitwise_or.reduce(neg, axis=0))


@pytest.mark.parametrize("L", [2, 127, 128, 129, 256, 300])
def test_chained_launch_plan(L, monkeypatch):
    """ceil(L / MAX_ROWS) launches, each later one folding the running
    result as its first pos row, and the exact flag row of the result."""
    calls = []
    real = t_lr.fold_plain

    def spy(rows, flags, n_pos, op):
        calls.append((len(rows), n_pos))
        return real(rows, flags, n_pos, op)
    monkeypatch.setattr(t_lr, "fold_plain", spy)
    m = _words(L, 2048, L)
    rf = torch.from_numpy(t_ops.np_row_flags(m))
    before = t_lr.launches
    out, out_flags = t_lr.fold(list(_w(m).unbind(0)), list(rf.unbind(0)),
                               op="or")
    assert t_lr.launches == before   # the CPU takes the plain version
    assert len(calls) == -(-L // t_lr.MAX_ROWS)
    assert calls[0] == (min(L, t_lr.MAX_ROWS),) * 2
    assert all(n == p for n, p in calls)
    assert all(n <= t_lr.MAX_ROWS + 1 for n, _ in calls)
    assert np.array_equal(_np(out), np.bitwise_or.reduce(m, axis=0))
    assert np.array_equal(out_flags.numpy(),
                          t_ops.np_row_flags(_np(out)))


def test_chained_diff_keeps_pos_before_neg(monkeypatch):
    calls = []
    real = t_lr.fold_plain

    def spy(rows, flags, n_pos, op):
        calls.append((len(rows), n_pos))
        return real(rows, flags, n_pos, op)
    monkeypatch.setattr(t_lr, "fold_plain", spy)
    m = _words(300, 1024, 7)
    m[:200] |= np.uint32(0xFFFF0FFF)
    rows = list(_w(m).unbind(0))
    out, _ = t_lr.fold(rows[:200], [None] * 200, rows[200:], [None] * 100)
    # 128 pos; the result + 72 pos + 56 neg; the result + 44 neg
    assert calls == [(128, 128), (129, 73), (45, 1)]
    assert np.array_equal(_np(out), np.bitwise_and.reduce(m[:200], axis=0)
                          & ~np.bitwise_or.reduce(m[200:], axis=0))


@pytest.mark.parametrize("C", [1000, 2049, 3072])
def test_row_flags_describe_the_words_present(C):
    m = _words(6, C, C)
    m[1, -(C % 1024 or 1024):] = 0xFFFFFFFF   # a ragged (or last) block
    got = t_lr.row_flags(_w(m)).numpy()
    nb = -(-C // 1024)
    for r in range(6):
        for b in range(nb):
            blk = m[r, b * 1024:(b + 1) * 1024]
            want = (t_wl.CLEAN0 if (blk == 0).all() else
                    t_wl.CLEAN1 if (blk == 0xFFFFFFFF).all() else t_wl.DIRTY)
            assert got[r, b] == want
    assert got[1, -1] == t_wl.CLEAN1
    if C % 1024 == 0:
        assert np.array_equal(got, t_ops.np_row_flags(m))


def test_one_row_is_returned_without_a_launch():
    m = _words(1, 1500, 3)
    t = _w(m)
    before = t_lr.launches
    out = t_ops.logical_reduce(t, "and")
    assert t_lr.launches == before
    assert np.array_equal(_np(out), m[0])
    assert np.array_equal(_np(t_ops.diff_reduce([t[0]], [None], [], [])),
                          m[0])


def test_rows_of_a_list_and_of_a_matrix_agree():
    m = _words(9, 3000, 4)
    rf = torch.from_numpy(t_ops.np_row_flags(
        np.pad(m, ((0, 0), (0, 4096 - 3000)))))
    a = t_ops.logical_reduce(_w(m), "xor", row_flags=rf)
    b = t_ops.logical_reduce(list(_w(m).unbind(0)), "xor",
                             row_flags=list(rf.unbind(0)))
    assert torch.equal(a, b)


def test_fold_rejects_what_the_kernel_does_not_take():
    r = torch.zeros(2048, dtype=torch.int32)
    f = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="op"):
        t_lr.fold([r, r], [f, f], op="andnot")
    with pytest.raises(ValueError, match="pos"):
        t_lr.fold([], [], [r], [f])
    with pytest.raises(TypeError):
        t_lr.fold([r, r.to(torch.int64)], [f, f])
    with pytest.raises(TypeError):
        t_lr.fold([r, r[None]], [f, f])
    with pytest.raises(TypeError):
        t_lr.fold([r, r], [f, f.to(torch.int64)])
    with pytest.raises(ValueError, match="words"):
        t_lr.fold([r, r[:1024]], [f, f])
    with pytest.raises(ValueError, match="flag row"):
        t_lr.fold([r, r], [f, f[:1]])
    with pytest.raises(ValueError, match="flag rows"):
        t_lr.fold([r, r], [f])
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_lr.fold([r.to("meta"), r.to("meta")], [None, None])
    with pytest.raises(ValueError):
        t_ops.logical_reduce(torch.zeros((0, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        t_ops.logical_reduce(np.zeros((2, 8), np.uint32))


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_executor_kernel_path_matches_ewah_and_reference(sort, monkeypatch):
    rng = np.random.default_rng(5)
    table, _ = synth.factorize(synth.uniform_table(1 << 13, 4, r=2, rng=rng,
                                                   base_card=100))
    names = ["a", "b", "c", "d"]
    r = r_dataset.Dataset.from_rows(table, names, sort=sort)
    t = t_dataset.Dataset.from_rows(table, names, sort=sort, device="cpu")
    wide = int(np.argmax(table.max(axis=0)))
    vals = sorted({int(v) for v in table[:60, wide]})
    vals2 = sorted({int(v) for v in table[:20, 1]})

    def exprs(col):
        w = col(names[wide])
        return {
            "or": w.isin(vals),
            "and_of_ors": w.isin(vals) & col("b").isin(vals2),
            "andnot": w.isin(vals) & col("b").isin(vals2)
            & ~(col("a") == int(table[3, 0])) & ~col("c").isin([1, 2, 3]),
        }
    calls = []
    real = t_lr.fold

    def spy(*args, **kwargs):
        calls.append(len(args[0]))
        return real(*args, **kwargs)
    monkeypatch.setattr(t_lr, "fold", spy)
    t_exprs, r_exprs = exprs(t_col), exprs(r_col)
    for name in t_exprs:
        calls.clear()
        got = t.query(backend="kernel").where(t_exprs[name]).bitmap()
        assert calls, name           # the fused kernel's path ran
        ewah = t.query(backend="ewah").where(t_exprs[name]).bitmap()
        want = r.query(backend="kernel").where(r_exprs[name]).bitmap()
        assert np.array_equal(got.to_words(), ewah.to_words()), name
        assert np.array_equal(got.to_words(), want.to_words()), name
        assert got.n_bits == want.n_bits


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_reduce_bytes_counts_the_row_blocks_the_result_needs():
    # the smoke script's bytes bound of the fused kernel
    smoke = _smoke()
    D, Z, O = t_wl.DIRTY, t_wl.CLEAN0, t_wl.CLEAN1
    cols = 4 * 1024 - 100                  # a ragged last block of 924

    def f(*v):
        return torch.tensor(v, dtype=torch.int32)
    # and-not: block 0 reads all 3; block 1 a pos CLEAN0 absorbs; block 2
    # the pos rows are identities, the neg row is read; block 3 a neg
    # CLEAN1 zeroes the result
    flags = [f(D, Z, O, D), f(D, D, O, O), f(D, D, D, O)]
    assert smoke.reduce_bytes(torch, t_lr, flags, 2, "and", cols) == \
        4 * (4 * 1024 + 12 + cols + 4)
    # or: block 1 reads one row, block 2 a CLEAN1 absorbs, block 3 reads
    # two ragged blocks
    flags = [f(D, Z, O, D), f(D, D, Z, D)]
    assert smoke.reduce_bytes(torch, t_lr, flags, 2, "or", cols) == \
        4 * (2048 + 1024 + 2 * 924 + 8 + cols + 4)
    # xor reads every dirty block; no flags: every block, no flag reads
    assert smoke.reduce_bytes(torch, t_lr, flags, 2, "xor", cols) == \
        4 * (2048 + 1024 + 2 * 924 + 8 + cols + 4)
    assert smoke.reduce_bytes(torch, t_lr, [None] * 3, 3, "and", cols) == \
        4 * (3 * cols + cols + 4)


def test_smoke_records_and_checks_the_main_path_reductions(monkeypatch):
    """The smoke's main-path phase on a CPU Dataset: the AND-NOT statement's
    fused reductions are recorded as the executor hands them over, and
    each passes ``reduce_case``'s checks."""
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = t_lr.fold_plain

    def counted(*args):             # a CPU "launch" per plain fold
        t_lr.launches += 1
        return real(*args)
    monkeypatch.setattr(t_lr, "fold_plain", counted)

    class Timer:
        flush = torch.empty(1)

        def ms(self, fn, reps=1, warm=0):
            fn()
            return 0.0
    table, measures = smoke.make_table(synth, 1 << 14, 0)
    ds = t_dataset.Dataset.from_rows(table, smoke.NAMES, sort="none",
                                     measures=measures, device="cpu")
    stmts, _, _ = smoke.statements(t_col, ds.table)
    seen = smoke.record_reductions(t_lr, ds, stmts)
    assert sorted(len(p) + len(n) for p, _, n, _, _ in seen) == [3, 40, 100]
    rows = smoke.main_path_case(torch, t_ops, t_lr, Timer(), ds, stmts, "x")
    assert sorted(r["label"] for r in rows) == [
        "main_path x 100-value or", "main_path x 40-value or",
        "main_path x and-not"]
    assert all(r["max_abs_err"] == 0 and r["launches"] == 1 for r in rows)
