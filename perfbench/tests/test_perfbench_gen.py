"""The SSB generator keeps dbgen's rules and the schema's cardinalities,
and the traffic generator gives every seed the same decks of templates."""
import numpy as np
import pytest

from perfbench.gen import ssb, traffic

SCALE = 0.01


@pytest.fixture(scope="module")
def table():
    return ssb.generate(2 ** 40 + 17, SCALE)


def col(t, name):
    return t["rows"][:, ssb.COLUMNS.index(name)]


def test_cardinalities_and_hierarchies(table):
    rows = table["rows"]
    assert rows.shape[1] == 14 == len(ssb.CARDS)
    assert sum(ssb.CARDS.values()) == 1795
    for i, name in enumerate(ssb.COLUMNS):
        assert rows[:, i].min() >= 0 and rows[:, i].max() < ssb.CARDS[name]
    assert (col(table, "p_category") // 5 == col(table, "p_mfgr")).all()
    assert (col(table, "p_brand1") // 40 == col(table, "p_category")).all()
    for side in "sc":
        nation = col(table, f"{side}_nation")
        assert (col(table, f"{side}_city") // 10 == nation).all()
        assert (col(table, f"{side}_region")
                == ssb.NATION_REGION[nation]).all()
    # every region holds five nations, as in TPC-H's NATION table
    assert np.bincount(ssb.NATION_REGION).tolist() == [5] * 5
    # the large columns reach most of their values at this scale
    assert len(np.unique(col(table, "p_brand1"))) > 800
    assert len(np.unique(col(table, "c_city"))) > 150


def test_dates_quantities_and_orders(table):
    year, month = col(table, "d_year"), col(table, "d_yearmonthnum")
    assert (month // 12 == year).all()
    assert month.max() == 6 * 12 + 7           # 1998-08 is the last month
    assert set(np.unique(col(table, "lo_discount"))) == set(range(11))
    assert set(np.unique(col(table, "lo_quantity"))) == set(range(50))
    n_orders = round(ssb.ORDERS_PER_SF * SCALE)
    assert n_orders <= len(table["rows"]) <= 7 * n_orders
    assert abs(len(table["rows"]) / n_orders - 4.0) < 0.1
    # lines of one order share date and customer: in load order, the
    # date changes at most once per order
    changes = (np.diff(col(table, "d_yearmonthnum")) != 0).sum()
    assert changes < n_orders
    y, m, w = ssb.calendar()
    assert (y[0], m[0], w[0]) == (0, 0, 0)
    assert (y[-1], m[-1]) == (6, 6 * 12 + 7) and w.max() == 52
    assert len(y) == 2406                       # 1992-01-01 .. 1998-08-02


def test_measures(table):
    m = table["measures"]
    assert set(m) == {"lo_revenue", "lo_extdisc", "lo_profit"}
    assert all(v.dtype == np.int64 and len(v) == len(table["rows"])
               for v in m.values())
    assert ssb.retail_price(np.array([1, 999, 200000])).tolist() == [
        90100, 189999, 110000]
    disc = col(table, "lo_discount")
    assert (m["lo_extdisc"] % np.maximum(disc, 1) == 0).all()
    assert (m["lo_revenue"] > 0).all()


def test_seed_determinism():
    a, b = ssb.generate(7, 0.001), ssb.generate(7, 0.001)
    assert np.array_equal(a["rows"], b["rows"])
    c = ssb.generate(2 ** 31 + 5, 0.001)
    assert not np.array_equal(a["rows"][:100], c["rows"][:100])


def test_decks_and_splits():
    mix = traffic.load_mix(traffic_path("flights"))
    seq = traffic.sequence(mix, 3)
    assert len(seq) == mix["max_queries"]
    names = list(mix["templates"])
    for d in range(5):
        assert [q["template"] for q in seq[13 * d:13 * d + 13]] == names
    again = traffic.sequence(mix, 3)
    assert again == seq
    # another seed: the same templates in the same order, other parameters
    other = traffic.sequence(mix, 4)
    assert [q["template"] for q in other] == [q["template"] for q in seq]
    assert [q["statements"] for q in other[:13]] != \
        [q["statements"] for q in seq[:13]]
    # three-column group-bys: one two-column statement per value of the
    # split column; the rest one statement each
    sizes = {}
    for q in seq[:13 * 20]:
        sizes.setdefault(q["template"], set()).add(len(q["statements"]))
        for st in q["statements"]:
            by = st["select"].get("by")
            assert by is None or len(by) <= 2
    assert sizes["q3.1"] == {5} and sizes["q3.2"] == {10}
    assert sizes["q3.3"] == {2} and sizes["q3.4"] == {2}
    assert sizes["q4.2"] == {5} and sizes["q4.3"] == {10}
    assert all(sizes[t] == {1} for t in
               ("q1.1", "q1.2", "q1.3", "q2.1", "q2.2", "q2.3", "q4.1"))


@pytest.mark.parametrize("seed", [4000000007, 3000000019, 2 ** 33 + 1])
def test_warmup_never_sends_a_window_query(seed):
    mix = traffic.load_mix(traffic_path("flights"))
    window = traffic.sequence(mix, seed)
    warm = traffic.warmup(mix, seed, window, 13)
    assert [q["template"] for q in warm] == list(mix["templates"])
    # not among the first five decks' queries (a run sends one or a few;
    # Q3.1 has five parameter values, which the window itself repeats)
    sent = [q["statements"] for q in window[:65]]
    assert all(q["statements"] not in sent for q in warm)
    # the templates with many parameter values warm with a query the
    # window never sends
    never = [q["statements"] for q in window]
    wide = ("q1.2", "q1.3", "q2.1", "q2.2", "q2.3", "q3.3", "q3.4", "q4.3")
    assert all(q["statements"] not in never for q in warm
               if q["template"] in wide)
    if seed == 4000000007:
        # this seed's other stream draws the window's first Q4.3 again
        other = traffic.sequence(mix, seed, stream=3)
        assert other[12]["statements"] == window[12]["statements"]
        assert warm[12] != other[12]


def traffic_path(name):
    from perfbench.run import HERE
    return HERE / "traffic" / f"{name}.json"
