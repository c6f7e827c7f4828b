"""``EWAH.to_words``, the dense path's way to a kernel operand: filled
from the run-list in whole-array passes, word for word the old walk over
``segments()`` (kept here as the oracle) and the reference's ``to_words``,
across the marker limits; a cold bitmap decodes its run-list once and a
memoized one not at all; a container-backed bitmap keeps its own path.
On the executor's kernel path on the CPU, ``_pad_and_flags`` gives the
padded words and row flags of the old walk, and a traced statement
records ``ewah.to_words`` inside ``kernel.upload``."""
import numpy as np
import pytest
import torch

from repro.core import ewah as r_ewah
from repro_torch.core import BitmapIndex, execute
from repro_torch.core import ewah as t_ewah
from repro_torch.core import store as t_store
from repro_torch.core.bitpack import pack_bits
from repro_torch.core.executor import Executor
from repro_torch.core.expr import And, In
from repro_torch.kernels import _trace
from repro_torch.kernels import ops as kops

ONES = 0xFFFFFFFF
SHARD_WORDS = 46_875    # one SF-1 shard's row of words


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)


def _segment_loop(bm):
    """The old ``to_words``: one slice assignment per segment."""
    out = np.empty(bm.n_words_uncompressed, dtype=np.uint32)
    pos = 0
    for seg in bm.segments():
        if seg[0] == "run":
            _, bit, cnt = seg
            out[pos:pos + cnt] = ONES if bit else 0
            pos += cnt
        else:
            out[pos:pos + len(seg[1])] = seg[1]
            pos += len(seg[1])
    assert pos == bm.n_words_uncompressed
    return out


def _literals(rng, n):
    """``n`` words that are neither clean zero nor clean one."""
    return rng.integers(1, ONES, size=n, dtype=np.uint64).astype(np.uint32)


def _w(*parts):
    return np.concatenate([np.asarray(p, np.uint32) for p in parts])


def _dense(name):
    """(dense words, n_bits) of the named case."""
    rng = np.random.default_rng(32)
    full = lambda w: (w, 32 * len(w))   # noqa: E731
    if name.startswith("random"):
        bits = rng.random(SHARD_WORDS * 32) < float(name.split("-")[1])
        return pack_bits(bits), len(bits)
    return {
        "empty": lambda: (np.empty(0, np.uint32), 0),
        "all_zero": lambda: full(np.zeros(1000, np.uint32)),
        "all_ones": lambda: full(np.full(1000, ONES, np.uint32)),
        "one_literal": lambda: full(_w([0x00F0_0F01])),
        "clean_max": lambda: full(_w(np.zeros(t_ewah.MAX_CLEAN), [5],
                                     np.full(t_ewah.MAX_CLEAN, ONES))),
        "clean_over": lambda: full(_w(
            np.full(2 * t_ewah.MAX_CLEAN + 7, ONES), _literals(rng, 3),
            np.zeros(t_ewah.MAX_CLEAN + 1))),
        "lit_max": lambda: full(_w([0], _literals(rng, t_ewah.MAX_LIT))),
        "lit_over": lambda: full(_w(
            np.zeros(9), _literals(rng, 2 * t_ewah.MAX_LIT + 5), [ONES])),
        "ragged_bits": lambda: (_w(np.full(40, ONES), _literals(rng, 2),
                                   [0x07FF_FFFF]), 43 * 32 - 5),
    }[name]()


WORD_CASES = ["empty", "all_zero", "all_ones", "one_literal", "clean_max",
              "clean_over", "lit_max", "lit_over", "ragged_bits",
              "random-0.001", "random-0.05", "random-0.5"]


def _bumps(rec, name):
    return [b.n for b in rec.bumps if b.name == name]


def _check_words(bm, got):
    """``got`` against the segment loop and the reference, on a bitmap
    that holds only ``bm``'s words."""
    assert got.dtype == np.uint32
    plain = t_ewah.EWAH(bm.words, bm.n_bits)
    assert np.array_equal(got, _segment_loop(plain))
    assert np.array_equal(
        got, r_ewah.EWAH(np.array(bm.words), bm.n_bits).to_words())


@pytest.mark.parametrize("memo", ["cold", "memoized"])
@pytest.mark.parametrize("name", WORD_CASES)
def test_to_words_matches_segment_loop_and_reference(name, memo):
    dense, n_bits = _dense(name)
    built = t_ewah.EWAH.from_words(dense, n_bits)
    if memo == "cold":
        bm = t_ewah.EWAH(np.array(built.words), n_bits)
        assert bm._rl is None
    else:
        bm = built
        assert (bm._rl is not None) == (len(dense) > 0)
    decodes = 0 if bm._rl is not None else 1
    before = _trace.counter_values().get("ewah.runlist.decodes", 0)
    with _trace.recording() as rec:
        got = bm.to_words()
        again = bm.to_words()
    after = _trace.counter_values().get("ewah.runlist.decodes", 0)
    assert after - before == decodes
    assert np.array_equal(got, dense) and np.array_equal(again, dense)
    n = bm.runlist().n_intervals
    assert _bumps(rec, "ewah.to_words.intervals") == [n, n]
    _check_words(bm, got)
    assert np.array_equal(bm.to_bool(), t_ewah.EWAH(
        bm.words, n_bits).to_bool())


def _fragmented_index():
    rng = np.random.default_rng(32)
    table = rng.integers(0, 10, size=(40_000, 2))
    return BitmapIndex.build(table, k=1)


EXPR = And((In(0, (1, 3, 5, 7)), In(1, (0, 2, 4))))


def test_kernel_result_fills_from_its_runlist():
    index = _fragmented_index()
    got = execute(index, EXPR, backend="kernel", device="cpu")
    assert got._rl is not None and got.runlist().n_intervals > 1
    before = _trace.counter_values().get("ewah.runlist.decodes", 0)
    with _trace.recording() as rec:
        words = got.to_words()
    assert _trace.counter_values().get("ewah.runlist.decodes", 0) == before
    assert _bumps(rec, "ewah.to_words.intervals") == [
        got.runlist().n_intervals]
    _check_words(got, words)
    want = execute(index, EXPR, backend="ewah", device="cpu")
    assert np.array_equal(words, want.to_words())


def test_container_backed_keeps_its_path():
    rng = np.random.default_rng(32)
    n_bits = 5 * (1 << 16) + 77
    pos = np.sort(rng.choice(n_bits, size=900, replace=False))
    bm = t_ewah.EWAH.from_positions(pos, n_bits, container="auto")
    assert bm._cont is not None and bm._words is None
    with _trace.recording() as rec:
        got = bm.to_words()
    # dense off the chunks: no words emitted, no run-list, no fill
    assert bm._words is None and bm._rl is None
    assert _bumps(rec, "ewah.to_words.intervals") == []
    _check_words(bm, got)
    ref = r_ewah.EWAH.from_positions(pos, n_bits, container="auto")
    assert np.array_equal(got, ref.to_words())


def _old_pad_and_flags(bm, cp):
    w = _segment_loop(t_ewah.EWAH(bm.words, bm.n_bits))
    w = np.pad(w, (0, cp - len(w)))
    return w, kops.np_row_flags(w)


@pytest.mark.parametrize("operand", ["composite", "store_physical"])
def test_pad_and_flags_as_before(operand, tmp_path):
    index = _fragmented_index()
    if operand == "composite":
        bm = execute(index, In(0, (1, 3, 5, 7)), backend="kernel",
                     device="cpu")
        assert bm._rl is not None
    else:
        path = t_store.save(index, str(tmp_path / "idx.ridx"))
        bm = t_store.load(path, mmap=True).bitmap(1, 3)
        assert bm._rl is None and bm._cont is None
    cp = kops.bucket_cols(bm.n_words_uncompressed)
    assert cp > bm.n_words_uncompressed
    want_w, want_f = _old_pad_and_flags(bm, cp)
    dev_w, dev_f = Executor._pad_and_flags(bm, cp, torch.device("cpu"))
    assert np.array_equal(kops.to_numpy_words(dev_w), want_w)
    assert np.array_equal(dev_f.numpy(), want_f)


def test_traced_statement_records_to_words_inside_upload():
    index = _fragmented_index()
    ors = [execute(index, c, backend="ewah", device="cpu")
           for c in EXPR.operands]
    with _trace.recording() as rec:
        got = execute(index, EXPR, backend="kernel", device="cpu")
    by_id = {s.id: s for s in rec}
    uploads = [s for s in rec if s.name == "kernel.upload"]
    fills = [s for s in rec if s.name == "ewah.to_words"]
    # seven physical operands under the two ORs, two composite under the AND
    assert len(uploads) == len(fills) == 9
    for s in fills:
        parent = by_id[s.parent]
        assert parent.name == "kernel.upload"
        assert parent.start <= s.start <= s.end <= parent.end
    bumps = _bumps(rec, "ewah.to_words.intervals")
    assert len(bumps) == 9
    assert bumps[-2:] == [bm.runlist().n_intervals for bm in ors]
    assert np.array_equal(got.words, execute(
        index, EXPR, backend="ewah", device="cpu").words)
