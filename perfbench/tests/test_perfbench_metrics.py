"""The benchmark's frozen arithmetic on hand-made flags and intervals,
with exact expected values, and each metric reader on a hand-made
record."""
import numpy as np
import pytest
import torch

import chip_smoke
from perfbench.metrics import arith
from perfbench.run import HERE, load_module
from repro_torch.kernels import logical_reduce as lr

D, C0, C1 = arith.DIRTY, arith.CLEAN0, arith.CLEAN1


def test_flag_values_are_the_programs():
    assert (D, C0, C1, arith.FLAG_COLS) == (lr.DIRTY, lr.CLEAN0, lr.CLEAN1,
                                            lr.FLAG_COLS)


@pytest.mark.parametrize("flags,n_pos,op,cols,want", [
    # and: the CLEAN0 column decides itself, nothing of it is read
    ([[D, C0], [D, D]], 2, "and", 2048, 4 * (2048 + 4 + 2048 + 2)),
    # or: CLEAN0 absorbs nothing, the dirty block of row 1 is read
    ([[D, C0], [D, D]], 2, "or", 2048, 4 * (3 * 1024 + 4 + 2048 + 2)),
    # and-not, a row read whole (None), a ragged last block of 476 words:
    # the neg row's CLEAN1 zeroes column 0
    ([[D, C1], None, [C1, D]], 2, "and", 1500,
     4 * (2 * 476 + 4 + 1500 + 2)),
    # xor absorbs nothing
    ([[C1, C1], [D, C0]], 2, "xor", 2048, 4 * (1024 + 4 + 2048 + 2)),
])
def test_reduce_bytes_exact(flags, n_pos, op, cols, want):
    f = [None if x is None else np.array(x) for x in flags]
    assert arith.reduce_bytes(f, n_pos, op, cols) == want


def test_reduce_bytes_is_the_smokes_rule():
    rng = np.random.default_rng(5)
    for _ in range(50):
        cols = int(rng.integers(1, 9000))
        nfc = arith.n_flag_cols(cols)
        n = int(rng.integers(2, 9))
        n_pos = int(rng.integers(1, n + 1))
        op = str(rng.choice(["and", "or", "xor"])) if n_pos == n else "and"
        flags = [None if rng.random() < 0.2 else
                 rng.integers(0, 3, nfc).astype(np.int32) for _ in range(n)]
        want = chip_smoke.reduce_bytes(
            torch, lr, [None if x is None else torch.from_numpy(x)
                        for x in flags], n_pos, op, cols)
        assert arith.reduce_bytes(flags, n_pos, op, cols) == want


def test_interval_union_and_gaps():
    iv = [(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (4.0, 4.0)]
    assert arith.merge(iv) == [[0.0, 3.0], [5.0, 6.0]]
    assert arith.union_length(iv) == 4.0
    assert arith.union_length(iv, 1.5, 5.5) == 2.0
    assert arith.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert arith.gaps(iv, -1.0, 2.5) == [(-1.0, 0.0)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"t_{name}")


def record(**kw):
    rec = {"n_rows": 6_000_000, "build_s": 40.0, "size_words": 30_000_000,
           "setup_s": 70.0, "store_open_s": 0.25, "seconds": 10.0,
           "records": [{"ok": True, "t_send": 0.1 * i - 0.1,
                        "t_done": 0.1 * i} for i in range(1, 11)]
           + [{"ok": False, "t_send": 1.0, "t_done": 1.05}],
           "cache_start": {"hits": 2, "misses": 10},
           "cache_end": {"hits": 5, "misses": 19},
           "launches": 30, "queries_completed": 10, "window_s": 10.0,
           "busy_s": 0.05, "reduce_bytes": 6.7e9,
           "kernel_s": {"void logical_reduce_kernel<true>(Params)": 0.004,
                        "other": 1.0}}
    rec.update(kw)
    return rec


def test_readers_on_a_record():
    rec = record()
    assert reader("queries_per_s").read(rec) == 10.0
    late = record(records=rec["records"] + [
        {"ok": True, "t_send": 1.05, "t_done": 12.5}])
    assert reader("queries_per_s").read(late) == 11 / 12.5
    assert reader("build_rows_per_s").read(rec) == 150_000.0
    assert reader("index_bytes_per_row").read(rec) == 20.0
    assert reader("setup_s").read(rec) == 70.0
    assert reader("store_open_s").read(rec) == 0.25
    assert reader("result_cache_hit_share").read(rec) == 25.0
    assert reader("reduce_launches_per_query").read(rec) == 3.0
    assert reader("device_idle_share").read(rec) == pytest.approx(99.5)
    assert reader("logical_reduce_roofline").read(rec) == \
        pytest.approx(100 * 6.7e9 / 3.35e12 / 0.004)


def test_readers_find_nothing():
    rec = record(launches=0, kernel_s={}, busy_s=0.0, queries_completed=0,
                 cache_end={"hits": 2, "misses": 10})
    for name in ("logical_reduce_roofline", "device_idle_share",
                 "reduce_launches_per_query", "result_cache_hit_share"):
        assert reader(name).read(rec) is None
