"""``EWAH.from_words``, the dense path's way back from a kernel's result
row: word for word the segment codec's output (``_emit`` over
``_split_literal``) and the reference's, across the marker limits, with its
run-list memoized and equal to a cold decode of the words; and, on the
executor's kernel path on the CPU, a kernel node's result that needs no
decode and counts its intervals."""
import numpy as np
import pytest

from repro.core import ewah as r_ewah
from repro_torch.core import BitmapIndex, execute
from repro_torch.core import ewah as t_ewah
from repro_torch.core.bitpack import pack_bits
from repro_torch.core.expr import And, In
from repro_torch.kernels import _trace

ONES = 0xFFFFFFFF
SHARD_WORDS = 46_875    # one SF-1 shard's row of words


@pytest.fixture(autouse=True)
def _no_recording(monkeypatch):
    monkeypatch.setattr(_trace, "_on", False)
    monkeypatch.setattr(_trace, "_recording", None)


def _literals(rng, n):
    """``n`` words that are neither clean zero nor clean one."""
    return rng.integers(1, ONES, size=n, dtype=np.uint64).astype(np.uint32)


def _w(*parts):
    return np.concatenate([np.asarray(p, np.uint32) for p in parts])


def _random_row(density):
    rng = np.random.default_rng(30)
    bits = rng.random(SHARD_WORDS * 32) < density
    return pack_bits(bits), len(bits)


def _case(name):
    """(words, n_bits) of the named case."""
    rng = np.random.default_rng(7)
    full = lambda w: (w, 32 * len(w))   # noqa: E731
    if name.startswith("random"):
        return _random_row(float(name.split("-")[1]))
    return {
        "empty": lambda: (np.empty(0, np.uint32), 0),
        "one_word": lambda: full(_w([0x00F0_0F01])),
        "all_zero": lambda: full(np.zeros(1000, np.uint32)),
        "all_ones": lambda: full(np.full(1000, ONES, np.uint32)),
        "clean_max": lambda: full(_w(np.zeros(t_ewah.MAX_CLEAN), [5])),
        "clean_over": lambda: full(_w(
            np.full(2 * t_ewah.MAX_CLEAN + 7, ONES), _literals(rng, 3),
            np.zeros(t_ewah.MAX_CLEAN + 1))),
        "lit_max": lambda: full(_w([0], _literals(rng, t_ewah.MAX_LIT))),
        "lit_over": lambda: full(_w(
            np.zeros(9), _literals(rng, 2 * t_ewah.MAX_LIT + 5), [ONES])),
        "leading_literal": lambda: full(_w(
            _literals(rng, 4), np.zeros(6), _literals(rng, 1),
            np.full(3, ONES))),
        "alternating": lambda: full(np.where(
            np.arange(5001) % 2 == 0,
            np.where(np.arange(5001) % 4 == 0, 0, ONES),
            _literals(rng, 5001)).astype(np.uint32)),
        "ragged_bits": lambda: (_w(np.full(40, ONES), _literals(rng, 2),
                                   [0x07FF_FFFF]), 43 * 32 - 5),
    }[name]()


CASES = ["empty", "one_word", "all_zero", "all_ones", "clean_max",
         "clean_over", "lit_max", "lit_over", "leading_literal",
         "alternating", "ragged_bits", "random-0.001", "random-0.01",
         "random-0.03", "random-0.1", "random-0.5"]


@pytest.mark.parametrize("name", CASES)
def test_from_words_matches_segment_codec(name):
    words, n_bits = _case(name)
    got = t_ewah.EWAH.from_words(words, n_bits)
    want = t_ewah._emit(t_ewah._split_literal(words))
    assert got.words.dtype == np.uint32
    assert np.array_equal(got.words, want)
    assert np.array_equal(got.words,
                          r_ewah.EWAH.from_words(words, n_bits).words)
    # the memoized run-list is a cold decode of the words, field for field
    if len(words):
        assert got._rl is not None
    cold = t_ewah._decode_runlist(got.words)
    rl = got.runlist()
    for field in ("bounds", "kinds", "lit_starts", "lits"):
        a, b = getattr(rl, field), getattr(cold, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    rebuilt = t_ewah.EWAH(got.words, n_bits)
    assert got.count() == rebuilt.count()
    for a, b in zip(got.set_intervals(), rebuilt.set_intervals()):
        assert np.array_equal(a, b)
    assert np.array_equal(got.to_words(), words)


def _fragmented_index():
    rng = np.random.default_rng(11)
    table = rng.integers(0, 10, size=(40_000, 2))
    return BitmapIndex.build(table, k=1)


def test_kernel_node_result_keeps_its_runlist():
    index = _fragmented_index()
    e = And((In(0, (1, 3, 5, 7)), In(1, (0, 2, 4))))
    nodes0 = _trace.counter_values().get("executor.nodes_kernel", 0)
    with _trace.recording() as rec:
        got = execute(index, e, backend="kernel", device="cpu")
    nodes = _trace.counter_values()["executor.nodes_kernel"] - nodes0
    bumps = [b.n for b in rec.bumps if b.name == "ewah.from_words.intervals"]
    # one bump a kernel node: the two ORs and the AND over them
    assert nodes == 3 and len(bumps) == 3
    assert bumps[-1] == got.runlist().n_intervals > 1

    decodes = _trace.counter_values().get("ewah.runlist.decodes", 0)
    iv = got.set_intervals()
    n = got.count()
    assert _trace.counter_values().get("ewah.runlist.decodes", 0) == decodes
    # a bitmap with only its words has to decode, and the counter says so
    rebuilt = t_ewah.EWAH(got.words, got.n_bits)
    assert np.array_equal(rebuilt.set_intervals()[0], iv[0])
    assert _trace.counter_values()["ewah.runlist.decodes"] == decodes + 1

    want = execute(index, e, backend="ewah", device="cpu")
    assert np.array_equal(got.words, want.words)
    assert n == want.count()
    for a, b in zip(iv, want.set_intervals()):
        assert np.array_equal(a, b)
