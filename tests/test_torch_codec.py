"""repro_torch host codec, sorts and index build vs the reference package.

The port keeps these modules as host NumPy copies, so every word, blob,
permutation and size must match the reference byte for byte.
"""
import numpy as np
import pytest

from repro.core import containers as r_cont
from repro.core import encoding as r_enc
from repro.core import ewah as r_ewah
from repro.core import index as r_index
from repro.core import layout as r_layout
from repro.core import sorting as r_sort
from repro.core import synth as r_synth
from repro_torch.core import containers as t_cont
from repro_torch.core import encoding as t_enc
from repro_torch.core import ewah as t_ewah
from repro_torch.core import index as t_index
from repro_torch.core import layout as t_layout
from repro_torch.core import sorting as t_sort
from repro_torch.core import synth as t_synth


def _positions(rng, n_bits, kind):
    if kind == "sparse":
        return np.flatnonzero(rng.random(n_bits) < 0.002)
    if kind == "runs":
        bits = np.zeros(n_bits, bool)
        for s in rng.integers(0, n_bits, 20):
            bits[s:s + int(rng.integers(1, 5000))] = True
        return np.flatnonzero(bits)
    if kind == "dense":
        return np.flatnonzero(rng.random(n_bits) < 0.6)
    return np.arange(n_bits)  # full


@pytest.mark.parametrize("kind", ["sparse", "runs", "dense", "full"])
@pytest.mark.parametrize("n_bits", [1, 31, 4096, 150_001])
@pytest.mark.parametrize("container", ["run", "auto"])
def test_ewah_words_and_container_blobs_match(kind, n_bits, container):
    rng = np.random.default_rng(n_bits + len(kind))
    pos = _positions(rng, n_bits, kind)
    r = r_ewah.EWAH.from_positions(pos, n_bits, container=container)
    t = t_ewah.EWAH.from_positions(pos, n_bits, container=container)
    assert np.array_equal(t.words, r.words)
    assert t.size_words == r.size_words
    assert t.count() == r.count()
    assert (t._cont is None) == (r._cont is None)
    if t._cont is not None:
        assert np.array_equal(t._cont.serialize(), r._cont.serialize())
        back = t_cont.Containers.deserialize(r._cont.serialize(), n_bits)
        assert np.array_equal(back.serialize(), r._cont.serialize())
    # logical ops over the copies stay byte-identical
    pos2 = _positions(rng, n_bits, "runs")
    r2 = r_ewah.EWAH.from_positions(pos2, n_bits, container=container)
    t2 = t_ewah.EWAH.from_positions(pos2, n_bits, container=container)
    for rop, top in ((r_ewah.and_many([r, r2]), t_ewah.and_many([t, t2])),
                     (r_ewah.or_many([r, r2]), t_ewah.or_many([t, t2])),
                     (r.andnot(r2), t.andnot(t2)), (~r, ~t)):
        assert np.array_equal(top.words, rop.words)
        assert np.array_equal(top.set_bits(), rop.set_bits())


def test_popcount_table_is_the_port_own():
    assert np.array_equal(t_ewah.POPCOUNT8,
                          [bin(i).count("1") for i in range(256)])
    w = np.random.default_rng(0).integers(0, 2**32, 999, dtype=np.uint32)
    assert t_ewah._popcount_words(w) == r_ewah._popcount_words(w)


@pytest.mark.parametrize("card,k,alloc", [(100, 1, "alpha"), (400, 2, "alpha"),
                                          (300, 2, "gray"), (50, 3, "gray")])
def test_encoder_codes_match(card, k, alloc):
    re_ = r_enc.ColumnEncoder(card, k, alloc)
    te = t_enc.ColumnEncoder(card, k, alloc)
    assert te.L == re_.L
    assert np.array_equal(te.all_codes(), re_.all_codes())


def _tables():
    rng = np.random.default_rng(5)
    uni = r_synth.uniform_table(1 << 13, 4, r=2, rng=np.random.default_rng(1))
    assert np.array_equal(
        uni, t_synth.uniform_table(1 << 13, 4, r=2,
                                   rng=np.random.default_rng(1)))
    cen, _ = r_synth.factorize(r_synth.census_like_table(1 << 12, rng))
    return {"uniform": uni, "census": cen}


@pytest.fixture(scope="module")
def tables():
    return _tables()


@pytest.mark.parametrize("name", ["uniform", "census"])
def test_sort_permutations_match(tables, name, tmp_path):
    t = tables[name]
    cards = [int(t[:, c].max()) + 1 for c in range(t.shape[1])]
    order = t_sort.order_columns_freq_aware(t, cards)
    assert order == r_sort.order_columns_freq_aware(t, cards)
    assert np.array_equal(t_sort.lex_sort(t, order), r_sort.lex_sort(t, order))
    for spill in (None, str(tmp_path)):
        got = t_sort.external_merge_sort_perm(t, 1000, order, spill_dir=spill)
        want = r_sort.external_merge_sort_perm(t, 1000, order,
                                               spill_dir=spill)
        assert np.array_equal(got, want)
    encs = [t_enc.ColumnEncoder(c, 2) for c in cards]
    r_encs = [r_enc.ColumnEncoder(c, 2) for c in cards]
    assert np.array_equal(t_sort.gray_sort(t, encs), r_sort.gray_sort(t, r_encs))


@pytest.mark.parametrize("name", ["uniform", "census"])
def test_layout_advice_matches(tables, name):
    t = tables[name]
    cards = [int(t[:, c].max()) + 1 for c in range(t.shape[1])]
    assert t_layout.advise_order(len(t), cards) == \
        r_layout.advise_order(len(t), cards)
    ts, rs = t_layout.LayoutStats(), r_layout.LayoutStats()
    for s in range(0, len(t), 777):
        ts.observe(t[s:s + 777])
        rs.observe(t[s:s + 777])
    td = ts.decision(sort="lex", remap=True, cards=cards)
    rd = rs.decision(sort="lex", remap=True, cards=cards)
    assert td.order == rd.order
    assert td.describe() == rd.describe()
    for a, b in zip(td.remaps, rd.remaps):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("name", ["uniform", "census"])
@pytest.mark.parametrize("sort", ["lex", "none"])
@pytest.mark.parametrize("k", [1, 2])
def test_index_words_and_size_match(tables, name, sort, k):
    t = tables[name]
    if sort == "lex":
        t = t[r_sort.lex_sort(t)]
    container = "run" if sort == "lex" else "auto"
    r = r_index.BitmapIndex.build(t, k=k, partition_rows=2048,
                                  container=container)
    p = t_index.BitmapIndex.build(t, k=k, partition_rows=2048,
                                  container=container)
    assert p.size_words == r.size_words
    assert p.words_per_column() == r.words_per_column()
    for c, (pc, rc) in enumerate(zip(p.columns, r.columns)):
        assert pc.encoder.L == rc.encoder.L
        for part_p, part_r in zip(pc.bitmaps, rc.bitmaps):
            for bp, br in zip(part_p, part_r):
                assert np.array_equal(bp.words, br.words), c
                assert (bp._cont is None) == (br._cont is None)
        for b in range(pc.encoder.L):
            assert np.array_equal(p.bitmap(c, b).words, r.bitmap(c, b).words)


def test_store_builds_are_not_in_the_port_yet(tmp_path):
    # the store has been ported since: a streamed store build writes the
    # reference's bytes and reopens to its words
    rows = np.random.default_rng(4).integers(0, 4, (3000, 2))
    built = {}
    for name, mod in (("r", r_index), ("t", t_index)):
        b = mod.IndexBuilder([4, 4], partition_rows=1024,
                             store_path=str(tmp_path / f"{name}.idx"))
        built[name] = b.append(rows).finish()
    assert (tmp_path / "t.idx").read_bytes() == \
        (tmp_path / "r.idx").read_bytes()
    for c in range(2):
        for b in range(4):
            assert np.array_equal(built["t"].bitmap(c, b).to_words(),
                                  built["r"].bitmap(c, b).to_words())


def test_containers_module_constants_match():
    assert t_cont.CHUNK_BITS == r_cont.CHUNK_BITS
    assert t_cont.CHUNK_WORDS == r_cont.CHUNK_WORDS
    assert (t_cont.T_EMPTY, t_cont.T_FULL, t_cont.T_ARRAY, t_cont.T_DENSE,
            t_cont.T_RUN) == (r_cont.T_EMPTY, r_cont.T_FULL, r_cont.T_ARRAY,
                              r_cont.T_DENSE, r_cont.T_RUN)
