"""The port's live ingest against the reference's, on the CPU.

WAL frames written by either package are byte-identical and replay in the
other; a torn tail is cut back to the valid prefix the same way.  A
store-backed live dataset is driven step by step (appends with their
measure values, deletes, a reopen that replays the log, compaction) in
both packages, and after every step each statement of the port, under the
three backends on ``device="cpu"``, must equal the reference's and a NumPy
oracle over the live rows; the files both leave behind must be
byte-identical.  Queries between mutations run the kernel path, whose
dense operands are cached per index object: they must never answer for
rows that changed.  ``Dataset.optimize`` re-sorts a saved unsorted copy to
the reference's bytes.  Exact equality everywhere.
"""
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core import ingest as r_ingest
from repro.core import synth
from repro.core import wal as r_wal
from repro.core.expr import col as r_col
from repro_torch.core import dataset as t_dataset
from repro_torch.core import ingest as t_ingest
from repro_torch.core import wal as t_wal
from repro_torch.core.expr import col as t_col


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep one file's torch work from taking every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


NAMES = ["a", "b", "c", "d"]
BACKENDS = ["ewah", "kernel", "auto"]


def _table(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 4, r=2, rng=rng,
                                                   base_card=20))
    return table, rng.integers(0, 10**6, n)


@pytest.fixture(scope="module")
def data():
    return _table()


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _same_files(d1, d2):
    names = sorted(f for f in os.listdir(d1) if not f.startswith("."))
    assert names == sorted(f for f in os.listdir(d2) if not f.startswith("."))
    for name in names:
        assert _sha(os.path.join(d1, name)) == _sha(os.path.join(d2, name)), \
            name
    return names


# -- WAL ----------------------------------------------------------------------

def _write_frames(wal_mod, path, rows, sales, e):
    w = wal_mod.WAL(path)
    w.log_epoch(3)
    w.log_append(rows[:40])
    w.log_append(rows[40:90], {"sales": sales[40:90],
                               "price": sales[40:90] / 7.0})
    w.log_delete(e)
    w.close()
    return path


def _decoded(wal_mod, path):
    frames, valid = wal_mod.replay(path)
    out = []
    for kind, payload in frames:
        k, val = wal_mod.decode_frame(kind, payload)
        if k == "append":
            val = val.tobytes()
        elif k == "appendm":
            val = (val[0].tobytes(),
                   {n: (a.dtype.str, a.tobytes()) for n, a in val[1].items()})
        elif k == "delete":
            val = repr(val)
        out.append((k, val))
    return out, valid


def test_wal_frames_byte_identical_and_cross_replay(data, tmp_path):
    table, sales = data
    r = _write_frames(r_wal, str(tmp_path / "r.log"), table, sales,
                      (r_col("a") == 2) & ~r_col("b").isin([1, 3]))
    t = _write_frames(t_wal, str(tmp_path / "t.log"), table, sales,
                      (t_col("a") == 2) & ~t_col("b").isin([1, 3]))
    assert _sha(r) == _sha(t)
    want, valid = _decoded(r_wal, r)
    assert valid == os.path.getsize(r)
    assert [k for k, _ in want] == ["epoch", "append", "appendm", "delete"]
    for path in (r, t):
        got, got_valid = _decoded(t_wal, path)
        assert got_valid == valid
        assert [k for k, _ in got] == [k for k, _ in want]
        assert [v for k, v in got if k != "delete"] == \
            [v for k, v in want if k != "delete"]
        assert got[-1][1].replace("repro_torch.", "repro.") == want[-1][1]


@pytest.mark.parametrize("cut", [3, 11, 20])
def test_wal_torn_tail_truncated_like_reference(data, tmp_path, cut):
    table, sales = data
    sizes = {}
    for name, mod, col in (("r", r_wal, r_col), ("t", t_wal, t_col)):
        path = _write_frames(mod, str(tmp_path / f"{name}.log"), table,
                             sales, col("c") == 1)
        full = os.path.getsize(path)
        with open(path, "ab") as f:           # a frame torn mid-write
            f.write(open(path, "rb").read()[64:64 + cut])
        frames, valid = mod.replay(path)
        assert valid == full and len(frames) == 4
        w = mod.WAL(path)                     # reopening truncates
        assert os.path.getsize(path) == full and w.n_frames == 4
        w.log_append(table[:5])
        w.close()
        sizes[name] = path
    assert _sha(sizes["r"]) == _sha(sizes["t"])
    assert len(t_wal.replay(sizes["r"])[0]) == 5


# -- live datasets, step by step ----------------------------------------------

class Oracle:
    """Rows, measure and alive mask, mutated in lockstep with a live index
    (a delete marks only the rows that exist when it runs)."""

    def __init__(self, rows, sales):
        self.card_c = int(rows[:, 2].max()) + 1
        self.rows = np.array(rows, copy=True)
        self.sales = np.array(sales, copy=True)
        self.alive = np.ones(len(rows), dtype=bool)

    def append(self, rows, sales):
        self.rows = np.concatenate([self.rows, rows])
        self.sales = np.concatenate([self.sales, sales])
        self.alive = np.concatenate([self.alive, np.ones(len(rows), bool)])

    def delete(self, mask_fn):
        self.alive &= ~mask_fn(self.rows)

    def answers(self, mask_fn):
        m = self.alive & mask_fn(self.rows)
        s = self.sales[m]
        return [int(m.sum()),
                np.bincount(self.rows[m, 2], minlength=self.card_c).tolist(),
                int(s.sum()),
                int(s.min()) if len(s) else None]


def _filters(col):
    return {
        "in": (col("a").isin([1, 3, 5, 7]),
               lambda r: np.isin(r[:, 0], [1, 3, 5, 7])),
        "andnot": (col("a").isin([0, 2, 4, 6, 8]) & ~(col("b") == 1),
                   lambda r: np.isin(r[:, 0], [0, 2, 4, 6, 8])
                   & (r[:, 1] != 1)),
    }


def _answers(ds, col, backend):
    out = {}
    for name, (e, _) in _filters(col).items():
        q = ds.query(backend).where(e)
        out[name] = [q.count(), q.group_by("c").count().tolist(),
                     q.sum("sales"), q.min("sales")]
        out[name + ".top"] = q.top_k("c", 3)
        out[name + ".rows"] = q.rows().tolist()
    return out


def _check(t, r, oracle, backends=BACKENDS):
    want = _answers(r, r_col, "ewah") if r is not None else None
    for backend in backends:
        got = _answers(t, t_col, backend)
        if want is not None:
            assert got == want, backend
        for name, (_, mask_fn) in _filters(t_col).items():
            assert got[name] == oracle.answers(mask_fn), (backend, name)


def _saved_pair(data, tmp_path, sort="lex"):
    table, sales = data
    ds = t_dataset.Dataset.from_rows(table, NAMES, sort=sort, shards=2,
                                     measures={"sales": sales},
                                     device="cpu")
    ds.save(str(tmp_path / "t"))
    shutil.copytree(tmp_path / "t", tmp_path / "r")
    perm = ds.row_perm if ds.row_perm is not None else np.arange(len(table))
    return ds.table, sales[perm]


def test_live_steps_match_reference_and_oracle(data, tmp_path):
    base_rows, base_sales = _saved_pair(data, tmp_path)
    rng = np.random.default_rng(5)
    t = t_dataset.Dataset.open(str(tmp_path / "t"), live=True, device="cpu")
    r = r_dataset.Dataset.open(str(tmp_path / "r"), live=True)
    oracle = Oracle(base_rows, base_sales)
    _check(t, r, oracle)
    for step in range(3):
        rows = np.stack([rng.integers(0, t.card(c), 700)
                         for c in range(4)], axis=1)
        s = rng.integers(0, 10**6, 700)
        assert t.index.append(rows, measures={"sales": s}) == \
            r.index.append(rows, measures={"sales": s}) == 700
        oracle.append(rows, s)
        _check(t, r, oracle)
        if step == 1:
            e_t = (t_col("d") == 2) | (t_col("a") == 5)
            e_r = (r_col("d") == 2) | (r_col("a") == 5)
            assert t.delete(e_t) == r.delete(e_r)
            oracle.delete(lambda x: (x[:, 3] == 2) | (x[:, 0] == 5))
            _check(t, r, oracle)
    assert t.index.stats() == r.index.stats()
    _same_files(tmp_path / "t", tmp_path / "r")          # the WALs too
    # a second reader replays the log to the same live state
    replayed = t_dataset.Dataset.open(str(tmp_path / "t"), device="cpu")
    assert replayed.index.pending_rows == t.index.pending_rows
    _check(replayed, r, oracle)
    replayed.index.close()
    info_t, info_r = t.compact(), r.compact()
    assert info_t == info_r and info_t["epoch"] == 1
    _same_files(tmp_path / "t", tmp_path / "r")
    _check(t, r, oracle)
    reopened = t_dataset.Dataset.open(str(tmp_path / "t"), device="cpu")
    _check(reopened, None, oracle, backends=["kernel"])
    for ds in (t, r, reopened):
        ds.index.close()


def test_kernel_queries_between_mutations_never_stale(data, tmp_path):
    base_rows, base_sales = _saved_pair(data, tmp_path, sort="none")
    t = t_dataset.Dataset.open(str(tmp_path / "t"), live=True, device="cpu")
    oracle = Oracle(base_rows, base_sales)
    rng = np.random.default_rng(9)
    for step in range(4):
        _check(t, None, oracle, backends=["kernel"])
        live = t.index
        base = live.base
        assert all(sh.dense_cache for sh in base.shards)
        rows = np.stack([rng.integers(0, t.card(c), 300)
                         for c in range(4)], axis=1)
        s = rng.integers(0, 10**6, 300)
        live.append(rows, measures={"sales": s})
        oracle.append(rows, s)
        _check(t, None, oracle, backends=["kernel"])
        v = int(rng.integers(0, 5))
        t.delete(t_col("b") == v)
        oracle.delete(lambda x, v=v: x[:, 1] == v)
        _check(t, None, oracle, backends=["kernel"])
        if step % 2:
            t.compact()
            assert live.base is not base       # a new base, new caches
            assert all(not sh.dense_cache for sh in live.base.shards)
            _check(t, None, oracle, backends=["kernel"])
    t.index.close()


def test_delta_memo_not_reused_across_compactions(data, tmp_path):
    base_rows, base_sales = _saved_pair(data, tmp_path)
    t = t_dataset.Dataset.open(str(tmp_path / "t"), live=True, device="cpu")
    oracle = Oracle(base_rows, base_sales)
    e, mask_fn = _filters(t_col)["in"]
    for value in (1, 2):
        # the delta's first version after each compaction: the memo of the
        # previous delta at that version must not answer for this one
        rows = np.full((50, 4), value, dtype=np.int64)
        s = np.full(50, value, dtype=np.int64)
        t.index.append(rows, measures={"sales": s})
        oracle.append(rows, s)
        for backend in BACKENDS:
            assert t.query(backend).where(e).count() == \
                oracle.answers(mask_fn)[0]
        t.compact()
    t.index.close()


def test_in_memory_live_dataset_and_compactor(data):
    table, sales = data
    kw = dict(sort="lex", shards=2, measures={"sales": sales})
    t = t_dataset.Dataset.from_rows(table, NAMES, device="cpu", **kw)
    r = r_dataset.Dataset.from_rows(table, NAMES, **kw)
    oracle = Oracle(t.table, sales[t.row_perm])
    rows = table[:333]
    for ds in (t, r):
        ds._ensure_live().append(rows, measures={"sales": sales[:333]})
    oracle.append(rows, sales[:333])
    assert isinstance(t.index, t_ingest.LiveIndex)
    assert t.index.wal is None and t.table is None
    assert t.delete(t_col("c") == 3) == r.delete(r_col("c") == 3)
    oracle.delete(lambda x: x[:, 2] == 3)
    _check(t, r, oracle)
    comp_t = t_ingest.Compactor(t.index, interval=3600, min_pending_rows=1)
    comp_r = r_ingest.Compactor(r.index, interval=3600, min_pending_rows=1)
    assert comp_t.maybe_compact() == comp_r.maybe_compact()
    assert comp_t.maybe_compact() is None and comp_t.stats()["runs"] == 1
    _check(t, r, oracle)


def test_optimize_matches_reference(data, tmp_path):
    base_rows, base_sales = _saved_pair(data, tmp_path, sort="none")
    oracle = Oracle(base_rows, base_sales)
    t = t_dataset.Dataset.open(str(tmp_path / "t"), device="cpu")
    r = r_dataset.Dataset.open(str(tmp_path / "r"))
    before = _answers(t, t_col, "kernel")
    info_t, info_r = t.optimize(), r.optimize()
    assert info_t == info_r
    _same_files(tmp_path / "t", tmp_path / "r")
    for backend in BACKENDS:
        got = _answers(t, t_col, backend)
        for name, (_, mask_fn) in _filters(t_col).items():
            assert got[name] == before[name] == oracle.answers(mask_fn)
    assert t_dataset.Dataset.open(str(tmp_path / "t"), device="cpu") \
        .size_words == info_t["size_words_after"]


_SMOKE_SCRIPT = r"""
import gc, importlib.util, sys
from pathlib import Path
import torch

root = Path(sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              root / "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from repro_torch.core import Dataset, col, synth
from repro_torch.kernels import logical_reduce as lr, ops, word_logical as wl


def cpu_bytes():
    # bytes of every live CPU tensor storage: the host's stand-in for
    # torch.cuda.memory_allocated
    seen = {}
    for o in gc.get_objects():
        if type(o) is torch.Tensor and o.device.type == "cpu":
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


torch.cuda.synchronize = lambda *a: None
torch.cuda.empty_cache = lambda *a: None
torch.cuda.memory_allocated = lambda *a: cpu_bytes()
plain = lr.fold_plain


def counted(*args):             # a CPU "launch" per plain fold
    lr.launches += 1
    return plain(*args)


lr.fold_plain = counted


class Timer:
    flush = torch.empty(1)

    def ms(self, fn, reps=1, warm=0):
        fn()
        return 0.0


smoke.DEVICE = "cpu"
smoke.ROWS_SORTED, smoke.ROWS_UNSORTED = 1 << 13, 1 << 12
smoke.APPEND_BATCHES, smoke.APPEND_ROWS = 3, 128
memory, built = {}, {}
for label, n, sort in (("sorted", smoke.ROWS_SORTED, "lex"),
                       ("unsorted", smoke.ROWS_UNSORTED, "none")):
    table, measures = smoke.make_table(synth, n, smoke.SEED)
    built[label] = Dataset.from_rows(table, smoke.NAMES, sort=sort,
                                     measures=measures, device="cpu")
    stmts, _, _ = smoke.statements(col, built[label].table)
    memory[label] = smoke.run_backend(built[label], stmts, "ewah", torch,
                                      wl, lr)[0]
rows, launches = smoke.store_phase(torch, ops, wl, lr, Timer(), synth,
                                   Dataset, col, memory, built["sorted"])
assert sorted(r["label"] for r in rows) == [
    "main_path store sorted shard 0 100-value or",
    "main_path store sorted shard 0 40-value or",
    "main_path store sorted shard 0 and-not"], rows
assert all(r["max_abs_err"] == 0 for r in rows)
assert launches["store_sorted_ewah"]["logical_reduce"] == 0
assert all(launches[k]["logical_reduce"] > 0 for k in (
    "store_sorted_kernel_cold", "store_unsorted_auto", "live_live",
    "live_replayed", "live_compacted", "pool_threads", "optimize"))
print("OK")
"""


def test_smoke_store_phase_on_cpu(tmp_path):
    """The smoke's store-and-live phase end to end on the CPU at a tiny
    size (the plain fold counted as a launch, host tensor bytes standing in
    for device memory), in a fresh interpreter that imports only the port:
    the phase forks shard workers."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SMOKE_SCRIPT, root],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(tmp_path),
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(root, "src")))
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert res.stdout.strip().endswith("OK")
