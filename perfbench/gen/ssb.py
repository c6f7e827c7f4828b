"""Star Schema Benchmark data from a seed, by dbgen's rules (SSB rev. 3).

LINEORDER is generated order by order, as dbgen loads it: ``1,500,000 x
scale`` orders of 1 to 7 lines, the lines of one order sharing its order
date and customer.  The dimension tables PART, SUPPLIER and CUSTOMER are
generated, then joined onto the fact rows, so each fact row carries the
fourteen denormalised dimension attributes that the bitmap index covers,
as value ranks:

    d_year           7    1992 .. 1998
    d_yearmonthnum  84    199201 .. 199812
    d_weeknuminyear 53    1 .. 53 (day of year // 7 + 1)
    lo_discount     11    0 .. 10
    lo_quantity     50    1 .. 50
    p_mfgr           5    MFGR#1 .. MFGR#5
    p_category      25    MFGR#11 .. MFGR#55 (5 per manufacturer)
    p_brand1      1000    MFGR#111 .. MFGR#5540 (40 per category)
    s_region, c_region    5    TPC-H's five regions
    s_nation, c_nation   25    TPC-H's 25 nations, 5 per region
    s_city, c_city      250    10 per nation

and three int64 measures, the products that Q1.x and Q4.x sum computed
once per row: ``lo_revenue``, ``lo_extendedprice * lo_discount`` and
``lo_revenue - lo_supplycost``.  Prices are in cents.

Everything is drawn from one ``numpy`` generator seeded by ``seed``, so a
seed gives the same table on every machine.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

COLUMNS: List[str] = [
    "d_year", "d_yearmonthnum", "d_weeknuminyear", "lo_discount",
    "lo_quantity", "p_mfgr", "p_category", "p_brand1", "s_region",
    "s_nation", "s_city", "c_region", "c_nation", "c_city"]
CARDS: Dict[str, int] = {
    "d_year": 7, "d_yearmonthnum": 84, "d_weeknuminyear": 53,
    "lo_discount": 11, "lo_quantity": 50, "p_mfgr": 5, "p_category": 25,
    "p_brand1": 1000, "s_region": 5, "s_nation": 25, "s_city": 250,
    "c_region": 5, "c_nation": 25, "c_city": 250}

ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 30_000
PARTS_PER_SF = 200_000
SUPPLIERS_PER_SF = 2_000
FIRST_YEAR = 1992
# order dates are uniform over 1992-01-01 .. 1998-08-02 (dbgen's STARTDATE
# to ENDDATE less 151 days)
FIRST_DAY = np.datetime64("1992-01-01")
LAST_DAY = np.datetime64("1998-08-02")

# TPC-H's NATION table: the region of each nation key
NATION_REGION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0,
                          0, 1, 2, 3, 4, 2, 3, 3, 1], dtype=np.int64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream (0 the data, 1 the traffic, ...) of a
    seed; any whole number is a seed."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def calendar():
    """Per day of the date range: (year rank, yearmonth rank, week rank)."""
    days = np.arange(FIRST_DAY, LAST_DAY + 1)
    years = days.astype("datetime64[Y]")
    months = days.astype("datetime64[M]")
    year = years.astype(np.int64) + 1970 - FIRST_YEAR
    month = months.astype(np.int64) - (FIRST_YEAR - 1970) * 12
    doy = (days - years.astype("datetime64[D]")).astype(np.int64)
    return year, month, doy // 7


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """TPC-H's P_RETAILPRICE of a part key (1-based), in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def generate(seed: int, scale: float = 1.0) -> Dict[str, np.ndarray]:
    """The fact table of one seed: ``{"rows": (n, 14) int64 value ranks in
    ``COLUMNS`` order, "measures": {name: (n,) int64}}``, in load order."""
    rng = rng_for(seed, 0)
    n_orders = max(int(round(ORDERS_PER_SF * scale)), 1)
    n_cust = max(int(round(CUSTOMERS_PER_SF * scale)), 1)
    n_part = max(int(round(PARTS_PER_SF * scale)), 1)
    n_supp = max(int(round(SUPPLIERS_PER_SF * scale)), 1)

    # dimension tables: one row per key
    p_mfgr = rng.integers(0, 5, n_part)
    p_category = p_mfgr * 5 + rng.integers(0, 5, n_part)
    p_brand1 = p_category * 40 + rng.integers(0, 40, n_part)
    s_nation = rng.integers(0, 25, n_supp)
    s_city = s_nation * 10 + rng.integers(0, 10, n_supp)
    c_nation = rng.integers(0, 25, n_cust)
    c_city = c_nation * 10 + rng.integers(0, 10, n_cust)

    # orders, then their lines
    lines = rng.integers(1, 8, n_orders)
    n_days = int((LAST_DAY - FIRST_DAY).astype(np.int64)) + 1
    o_day = rng.integers(0, n_days, n_orders)
    o_cust = rng.integers(0, n_cust, n_orders)
    day = np.repeat(o_day, lines)
    cust = np.repeat(o_cust, lines)
    n = len(day)
    part = rng.integers(0, n_part, n)
    supp = rng.integers(0, n_supp, n)
    quantity = rng.integers(1, 51, n)
    discount = rng.integers(0, 11, n)

    year, month, week = calendar()
    rows = np.empty((n, len(COLUMNS)), dtype=np.int64)
    rows[:, 0] = year[day]
    rows[:, 1] = month[day]
    rows[:, 2] = week[day]
    rows[:, 3] = discount
    rows[:, 4] = quantity - 1
    rows[:, 5] = p_mfgr[part]
    rows[:, 6] = p_category[part]
    rows[:, 7] = p_brand1[part]
    rows[:, 9] = s_nation[supp]
    rows[:, 8] = NATION_REGION[rows[:, 9]]
    rows[:, 10] = s_city[supp]
    rows[:, 12] = c_nation[cust]
    rows[:, 11] = NATION_REGION[rows[:, 12]]
    rows[:, 13] = c_city[cust]

    price = retail_price(part + 1)
    extended = quantity * price
    revenue = extended * (100 - discount) // 100
    supplycost = 6 * price // 10
    return {"rows": rows,
            "measures": {"lo_revenue": revenue,
                         "lo_extdisc": extended * discount,
                         "lo_profit": revenue - supplycost}}
