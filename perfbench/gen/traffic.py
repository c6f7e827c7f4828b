"""The one traffic generator: a mix file of parameters in, the statement
sequence of a run out.

A mix is a JSON file under ``perfbench/traffic/``:

    {"clients": 1,                          # analysts in a closed loop
     "warmup_queries": 13,                  # sent before the window
     "max_queries": 2600,
     "templates": {"q1.1": 1, ...}}         # copies per deck

The sequence is a run of decks: each deck holds every template of the mix
as many times as its weight, in the mix file's order, so every seed sends
the same templates in the same order and the seed changes only their
parameters (the work of a window does not depend on the seed's draw of
templates), and the client sends whole decks.  Each query draws its
substitution parameters from the seed over its template's domain and
becomes one or more of the service's JSON statements (``POST /query``
bodies): SSB's three-column group-bys become one two-column statement per
value of one grouping column (the engine groups by at most two columns),
and the analyst waits for all of them.

Templates are named ``q<flight>.<n>``: SSB rev. 3's thirteen queries.
"""
from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, List, Sequence

import numpy as np

from perfbench.gen.ssb import CARDS, NATION_REGION, rng_for

def deck_size(mix: Dict) -> int:
    return sum(int(w) for w in mix["templates"].values())


def load_mix(path) -> Dict:
    with open(path) as f:
        mix = json.load(f)
    if not mix.get("templates"):
        raise ValueError(f"{path}: no templates")
    return mix


# -- wire helpers --------------------------------------------------------------

def eq(col: str, v: int) -> Dict:
    return {"op": "eq", "col": col, "value": int(v)}


def isin(col: str, vs: Sequence[int]) -> Dict:
    return {"op": "in", "col": col, "values": [int(v) for v in vs]}


def between(col: str, lo: int, hi: int) -> Dict:
    return {"op": "range", "col": col, "lo": int(lo), "hi": int(hi)}


def conj(*args: Dict) -> Dict:
    return {"op": "and", "args": list(args)}


def sum_by(measure: str, by: Sequence[str], where: Dict) -> Dict:
    return {"select": {"sum": measure, "by": list(by)}, "where": where}


def split_group_by(measure: str, by: Sequence[str],
                   values: Dict[str, Sequence[int]], where: Dict
                   ) -> List[Dict]:
    """A three-column group-by as two-column statements: one per value
    that the filter leaves to one grouping column, that column chosen so
    that the statements' result cells (values x the other two columns'
    cardinalities) are fewest, the first such column on a tie."""
    def cells(c):
        a, b = [x for x in by if x != c]
        return len(values[c]) * CARDS[a] * CARDS[b]
    split = min(by, key=cells)
    rest = [x for x in by if x != split]
    return [sum_by(measure, rest, conj(where, eq(split, v)))
            for v in values[split]]


def nations_of(region: int) -> List[int]:
    return [int(n) for n in np.flatnonzero(NATION_REGION == region)]


def cities_of(nation: int) -> List[int]:
    return list(range(nation * 10, nation * 10 + 10))


# -- SSB rev. 3's thirteen templates -------------------------------------------
# Each takes the query's generator and returns its statements.  Value ranks:
# d_year 0 = 1992, d_yearmonthnum 0 = 1992-01, d_weeknuminyear 0 = week 1,
# lo_quantity 0 = quantity 1, lo_discount = the discount.

def _flight1(rng, date: Dict, d_lo_hi, q_lo_hi) -> List[Dict]:
    where = conj(date, between("lo_discount", *d_lo_hi),
                 between("lo_quantity", *q_lo_hi))
    return [{"select": {"sum": "lo_extdisc"}, "where": where}]


def q1_1(rng) -> List[Dict]:
    d = int(rng.integers(2, 10))
    return _flight1(rng, eq("d_year", rng.integers(1, 6)), (d - 1, d + 1),
                    (0, 23))                        # quantity < 25


def q1_2(rng) -> List[Dict]:
    d, q = int(rng.integers(2, 10)), int(rng.integers(0, 41))
    month = int(rng.integers(12, 72))               # 1993-01 .. 1997-12
    return _flight1(rng, eq("d_yearmonthnum", month), (d - 1, d + 1),
                    (q, q + 9))


def q1_3(rng) -> List[Dict]:
    d, q = int(rng.integers(2, 10)), int(rng.integers(0, 41))
    date = conj(eq("d_weeknuminyear", rng.integers(0, 52)),
                eq("d_year", rng.integers(1, 6)))
    return _flight1(rng, date, (d - 1, d + 1), (q, q + 9))


def q2_1(rng) -> List[Dict]:
    where = conj(eq("p_category", rng.integers(0, 25)),
                 eq("s_region", rng.integers(0, 5)))
    return [sum_by("lo_revenue", ["d_year", "p_brand1"], where)]


def q2_2(rng) -> List[Dict]:
    lo = int(rng.integers(0, 25)) * 40 + int(rng.integers(0, 33))
    where = conj(between("p_brand1", lo, lo + 7),
                 eq("s_region", rng.integers(0, 5)))
    return [sum_by("lo_revenue", ["d_year", "p_brand1"], where)]


def q2_3(rng) -> List[Dict]:
    where = conj(eq("p_brand1", rng.integers(0, 1000)),
                 eq("s_region", rng.integers(0, 5)))
    return [sum_by("lo_revenue", ["d_year", "p_brand1"], where)]


SIX_YEARS = list(range(0, 6))                       # 1992 .. 1997
LAST_TWO_YEARS = [5, 6]                             # 1997, 1998 (Q4.2, Q4.3)


def q3_1(rng) -> List[Dict]:
    r = int(rng.integers(0, 5))
    where = conj(eq("c_region", r), eq("s_region", r),
                 between("d_year", 0, 5))
    return split_group_by(
        "lo_revenue", ["c_nation", "s_nation", "d_year"],
        {"c_nation": nations_of(r), "s_nation": nations_of(r),
         "d_year": SIX_YEARS}, where)


def q3_2(rng) -> List[Dict]:
    n = int(rng.integers(0, 25))
    where = conj(eq("c_nation", n), eq("s_nation", n),
                 between("d_year", 0, 5))
    return split_group_by(
        "lo_revenue", ["c_city", "s_city", "d_year"],
        {"c_city": cities_of(n), "s_city": cities_of(n),
         "d_year": SIX_YEARS}, where)


def _city_pair(rng) -> List[int]:
    n = int(rng.integers(0, 25))
    return sorted(int(c) for c in rng.choice(cities_of(n), 2, replace=False))


def q3_3(rng) -> List[Dict]:
    cities = _city_pair(rng)
    where = conj(isin("c_city", cities), isin("s_city", cities),
                 between("d_year", 0, 5))
    return split_group_by(
        "lo_revenue", ["c_city", "s_city", "d_year"],
        {"c_city": cities, "s_city": cities, "d_year": SIX_YEARS}, where)


def q3_4(rng) -> List[Dict]:
    cities = _city_pair(rng)
    month = int(rng.integers(0, 72))                # 1992-01 .. 1997-12
    where = conj(isin("c_city", cities), isin("s_city", cities),
                 eq("d_yearmonthnum", month))
    return split_group_by(
        "lo_revenue", ["c_city", "s_city", "d_year"],
        {"c_city": cities, "s_city": cities, "d_year": [month // 12]},
        where)


def _mfgr_pair(rng) -> List[int]:
    return sorted(int(m) for m in rng.choice(5, 2, replace=False))


def q4_1(rng) -> List[Dict]:
    r = int(rng.integers(0, 5))
    where = conj(eq("c_region", r), eq("s_region", r),
                 isin("p_mfgr", _mfgr_pair(rng)))
    return [sum_by("lo_profit", ["d_year", "c_nation"], where)]


def q4_2(rng) -> List[Dict]:
    r, mfgrs = int(rng.integers(0, 5)), _mfgr_pair(rng)
    where = conj(eq("c_region", r), eq("s_region", r),
                 isin("d_year", LAST_TWO_YEARS), isin("p_mfgr", mfgrs))
    return split_group_by(
        "lo_profit", ["d_year", "s_nation", "p_category"],
        {"d_year": LAST_TWO_YEARS, "s_nation": nations_of(r),
         "p_category": [m * 5 + c for m in mfgrs for c in range(5)]},
        where)


def q4_3(rng) -> List[Dict]:
    n, c = int(rng.integers(0, 25)), int(rng.integers(0, 25))
    where = conj(eq("s_nation", n), isin("d_year", LAST_TWO_YEARS),
                 eq("c_region", NATION_REGION[n]), eq("p_category", c))
    return split_group_by(
        "lo_profit", ["d_year", "s_city", "p_brand1"],
        {"d_year": LAST_TWO_YEARS, "s_city": cities_of(n),
         "p_brand1": list(range(c * 40, c * 40 + 40))}, where)


TEMPLATES: Dict[str, Callable] = {
    "q1.1": q1_1, "q1.2": q1_2, "q1.3": q1_3,
    "q2.1": q2_1, "q2.2": q2_2, "q2.3": q2_3,
    "q3.1": q3_1, "q3.2": q3_2, "q3.3": q3_3, "q3.4": q3_4,
    "q4.1": q4_1, "q4.2": q4_2, "q4.3": q4_3,
}


def sequence(mix: Dict, seed: int, stream: int = 1) -> List[Dict]:
    """The run's queries, in the order they are sent: ``[{"template":
    name, "statements": [body, ...]}, ...]``, ``mix["max_queries"]`` of
    them, in decks of ``deck_size(mix)``."""
    unknown = sorted(set(mix["templates"]) - set(TEMPLATES))
    if unknown:
        raise ValueError(f"unknown templates {unknown}")
    rng = rng_for(seed, stream)
    deck = [name for name, w in mix["templates"].items()
            for _ in range(int(w))]
    return [{"template": name, "statements": TEMPLATES[name](rng)}
            for _, name in zip(range(int(mix["max_queries"])),
                               itertools.cycle(deck))]


def warmup(mix: Dict, seed: int, queries: List[Dict], n: int) -> List[Dict]:
    """The warm-up's ``n`` queries, in deck order, from another stream of
    the seed: for each, of that stream's queries of its template, one that
    the window's ``queries`` never send, else the one they send last; the
    service's per-shard caches outlive its result cache and would answer
    the window's query from the warm-up's."""
    first = {}
    for j, q in enumerate(queries):
        first.setdefault(json.dumps(q["statements"]), j)
    other = sequence(mix, seed, stream=3)
    deck = deck_size(mix)
    return [max(other[i % deck::deck],
                key=lambda q: first.get(json.dumps(q["statements"]),
                                        len(queries)))
            for i in range(n)]
