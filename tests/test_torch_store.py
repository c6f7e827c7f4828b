"""The port's index store against the reference's, on the CPU.

The same fact table, made with NumPy from a seed, is built by ``repro`` and
by ``repro_torch`` (``device="cpu"``) and saved by each package's store.
The files must be byte-identical (single files of format v1 to v4, sharded
directories with their manifests, streamed builds and single-shard
rewrites); each package must open the other's files and read the same
words, measures and statement results; both must reject the same damaged
files and report the same ``scrub`` findings.  The dense operand cache of
an index opened from a memory map must own its memory, never alias the
file.  Exact equality everywhere: the store holds integers.
"""
import hashlib
import os
import struct

import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core import index as r_index
from repro.core import store as r_store
from repro.core import synth
from repro.core.expr import col as r_col
from repro_torch.core import dataset as t_dataset
from repro_torch.core import index as t_index
from repro_torch.core import store as t_store
from repro_torch.core.executor import Executor, execute as t_execute
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
PACKAGES = {"repro": (r_dataset, r_store, r_col),
            "repro_torch": (t_dataset, t_store, t_col)}

# build variants and the format version each one's files carry
VARIANTS = {
    "v2_runs": (dict(sort="lex"), 2),
    "v2_containers": (dict(sort="none"), 2),
    "v3_remap": (dict(sort="lex", remap=True), 3),
    "v4_measures": (dict(sort="lex", measures=True), 4),
}


def _table(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 4, r=2, rng=rng,
                                                   base_card=30))
    measures = {"sales": rng.integers(-10**12, 10**12, n),
                "price": rng.standard_normal(n) * 100.0}
    return table, measures


@pytest.fixture(scope="module")
def data():
    return _table()


def _build(pkg, data, variant, **extra):
    table, measures = data
    ds_mod = PACKAGES[pkg][0]
    kw = dict(VARIANTS[variant][0])
    if kw.pop("measures", False):
        kw["measures"] = measures
    kw.update(extra)
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    return ds_mod.Dataset.from_rows(table, NAMES, partition_rows=2048, **kw)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _version(path):
    with open(path, "rb") as f:
        return struct.unpack("<I", f.read(12)[8:12])[0]


def _filters(col):
    return [col("a").isin([1, 3, 5, 7, 9]),
            col("a").isin([0, 2, 4, 6]) & ~(col("b") == 2),
            (col("c") == 1) | ~col("d").isin([0, 5, 6])]


def _statements(ds, col, backend=None):
    out = []
    for e in _filters(col):
        q = ds.query(backend=backend) if backend else ds.query()
        q = q.where(e)
        out += [q.count(), q.group_by("c").count().tolist(),
                q.top_k("b", 4), q.rows(limit=50).tolist()]
        if "sales" in (ds.measure_names or []):
            out += [q.sum("sales"), q.min("sales"), q.max("sales"),
                    q.group_by("a").sum("sales").tolist()]
    return out


def _words(index):
    return [(c, p, b, np.asarray(bm.to_words()).tobytes())
            for c, ci in enumerate(index.columns)
            for p, part in enumerate(ci.bitmaps)
            for b, bm in enumerate(part)]


# -- byte identity -----------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_single_file_bytes_identical(data, tmp_path, variant):
    paths = {}
    for pkg in PACKAGES:
        ds = _build(pkg, data, variant)
        paths[pkg] = PACKAGES[pkg][1].save(ds.index,
                                           str(tmp_path / f"{pkg}.ridx"))
    assert _sha(paths["repro"]) == _sha(paths["repro_torch"])
    assert _version(paths["repro_torch"]) == VARIANTS[variant][1]
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_sharded_directory_bytes_identical(data, tmp_path, sort):
    table, measures = data
    r = r_dataset.Dataset.from_rows(table, NAMES, sort=sort, shards=3,
                                    measures=measures)
    t = t_dataset.Dataset.from_rows(table, NAMES, sort=sort, shards=3,
                                    measures=measures, device="cpu")
    r.save(str(tmp_path / "r"))
    t.save(str(tmp_path / "t"))
    names = sorted(os.listdir(tmp_path / "r"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert names == ["manifest.json"] + [f"shard-{i:05d}.ridx"
                                         for i in range(3)]
    for name in names:
        assert _sha(tmp_path / "r" / name) == _sha(tmp_path / "t" / name)
    assert t_store.manifest_meta(str(tmp_path / "t")) == \
        r_store.manifest_meta(str(tmp_path / "r"))
    assert [f[0] for f in t_store.shard_fingerprints(str(tmp_path / "r"))] \
        == [f[0] for f in r_store.shard_fingerprints(str(tmp_path / "r"))]


def test_streamed_build_bytes_identical(data, tmp_path):
    table, _ = data
    cards = [int(table[:, c].max()) + 1 for c in range(4)]
    out = {}
    for pkg, mod in (("repro", r_index), ("repro_torch", t_index)):
        path = str(tmp_path / f"{pkg}.ridx")
        b = mod.IndexBuilder(cards, k=2, partition_rows=1024,
                             column_names=NAMES, store_path=path)
        for s in range(0, len(table), 1500):
            b.append(table[s:s + 1500])
        out[pkg] = (path, b, b.finish())
    assert _sha(out["repro"][0]) == _sha(out["repro_torch"][0])
    _, builder, streamed = out["repro_torch"]
    # nothing was retained in the builder; the result is the file, mapped
    assert all(len(c.bitmaps) == 0 for c in builder.columns)
    bm = streamed.columns[0].bitmaps[0][0]
    assert not bm.words.flags.writeable
    assert _words(streamed) == _words(out["repro"][2])
    aborted = t_index.IndexBuilder(cards, store_path=str(tmp_path / "x"))
    aborted.append(table[:100])
    aborted.abort()
    assert not [f for f in os.listdir(tmp_path) if f.startswith("x")]


def test_replaced_shard_file_bytes_identical(data, tmp_path):
    table, _ = data
    files = {}
    for pkg in PACKAGES:
        ds_mod, store, _ = PACKAGES[pkg]
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        ds = ds_mod.Dataset.from_rows(table, NAMES, shards=2, **kw)
        d = str(tmp_path / pkg)
        ds.save(d)
        new = ds_mod.Dataset.from_rows(table[:3008][::-1], NAMES,
                                       cards=ds._cards, sort="none",
                                       **kw).index
        ds.index.replace_shard_file(d, 0, new)
        files[pkg] = d
    for name in sorted(os.listdir(files["repro"])):
        assert _sha(os.path.join(files["repro"], name)) == \
            _sha(os.path.join(files["repro_torch"], name))


# -- cross-open --------------------------------------------------------------

@pytest.mark.parametrize("mmap", [True, False])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_cross_open_same_words_measures_statements(data, tmp_path, writer,
                                                   mmap):
    table, measures = data
    ds_mod = PACKAGES[writer][0]
    kw = {"device": "cpu"} if writer == "repro_torch" else {}
    ds_mod.Dataset.from_rows(table, NAMES, sort="lex", shards=3,
                             measures=measures, **kw).save(str(tmp_path))
    r = r_dataset.Dataset.open(str(tmp_path), mmap=mmap)
    t = t_dataset.Dataset.open(str(tmp_path), mmap=mmap, device="cpu")
    assert t.n_shards == r.n_shards == 3
    assert t.sort_order == r.sort_order and t._cards == r._cards
    for rs, ts in zip(r.index.shards, t.index.shards):
        assert _words(ts) == _words(rs)
        for name in ("sales", "price"):
            assert np.asarray(ts.measures[name]).tobytes() == \
                np.asarray(rs.measures[name]).tobytes()
    want = _statements(r, r_col, "ewah")
    for backend in BACKENDS:
        assert _statements(t, t_col, backend) == want


def test_v1_file_opens_in_both(data, tmp_path):
    ds = _build("repro_torch", data, "v2_runs")
    path = t_store.save(ds.index, str(tmp_path / "v1.ridx"))
    with open(path, "r+b") as f:       # a v1 file is v2 without container
        f.seek(8)                      # segments: only the version differs
        f.write(struct.pack("<I", 1))
    r = r_store.load(path)
    for mmap in (True, False):
        t = t_store.load(path, mmap=mmap)
        assert _words(t) == _words(r) == _words(ds.index)
        e_t = t_col("a").isin([1, 2]) & ~(t_col("c") == 0)
        e_r = r_col("a").isin([1, 2]) & ~(r_col("c") == 0)
        for backend in BACKENDS:
            assert t_execute(t, e_t, backend=backend, device="cpu") \
                .set_bits().tolist() == \
                r_dataset.Dataset(r).query("ewah").where(e_r).rows() \
                .tolist()


def test_empty_and_single_value_indexes(tmp_path):
    for pkg, mod, store in (("repro", r_index, r_store),
                            ("repro_torch", t_index, t_store)):
        empty = mod.IndexBuilder([4, 9], column_names=["a", "b"]).finish()
        store.save(empty, str(tmp_path / f"{pkg}-empty.ridx"))
        ones = mod.BitmapIndex.build(np.zeros((100, 2), np.int64),
                                     cards=[1, 1])
        store.save(ones, str(tmp_path / f"{pkg}-ones.ridx"))
    for name in ("empty", "ones"):
        assert _sha(tmp_path / f"repro-{name}.ridx") == \
            _sha(tmp_path / f"repro_torch-{name}.ridx")
    loaded = t_store.load(str(tmp_path / "repro-ones.ridx"))
    assert loaded.equality_bitmap(0, 0).count() == 100
    assert t_store.load(str(tmp_path / "repro-empty.ridx")).n_rows == 0


# -- rejections and scrub ----------------------------------------------------

def _damage(path, how):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if how == "truncated":
            f.truncate(size - 16)
        elif how == "preamble":
            f.truncate(t_store.PAYLOAD_START // 2)
        elif how == "payload_byte":
            f.seek(t_store.PAYLOAD_START + 5)
            b = f.read(1)
            f.seek(t_store.PAYLOAD_START + 5)
            f.write(bytes([b[0] ^ 0xFF]))
        elif how == "header_byte":
            hdr_off = t_store._PREAMBLE.unpack(
                f.read(t_store._PREAMBLE.size))[3]
            f.seek(hdr_off + 3)
            b = f.read(1)
            f.seek(hdr_off + 3)
            f.write(bytes([b[0] ^ 0xFF]))
        elif how == "version":
            f.seek(8)
            f.write(struct.pack("<I", 99))
        elif how == "magic":
            f.write(b"NOTANIDX")


def _measure_row_count_file(data, tmp_path):
    """A v4 file whose measure TOC claims one row fewer in partition 0
    than its bitmaps hold (header CRC recomputed, so only the cross-check
    can catch it)."""
    import json
    import zlib
    ds = _build("repro_torch", data, "v4_measures")
    path = t_store.save(ds.index, str(tmp_path / "m.ridx"))
    with open(path, "r+b") as f:
        pre = t_store._PREAMBLE.unpack(f.read(t_store._PREAMBLE.size))
        hdr_off, hdr_len = pre[3], pre[4]
        f.seek(hdr_off)
        meta = json.loads(f.read(hdr_len))
        meta["measures"]["sales"]["toc"][0][1] -= 1
        raw = json.dumps(meta, separators=(",", ":")).encode()
        f.seek(hdr_off)
        f.write(raw)
        f.truncate(hdr_off + len(raw))
        f.seek(0)
        f.write(t_store._PREAMBLE.pack(pre[0], pre[1], pre[2], hdr_off,
                                       len(raw), zlib.crc32(raw)))
    return path


DAMAGE = {
    "truncated": ("StoreCorruptError", [True, False]),
    "preamble": ("StoreCorruptError", [True, False]),
    "payload_byte": ("StoreCorruptError", [False]),
    "header_byte": ("StoreCorruptError", [True, False]),
    "version": ("StoreVersionError", [True, False]),
    "magic": ("StoreVersionError", [True, False]),
    "measure_rows": ("StoreCorruptError", [True, False]),
}


@pytest.mark.parametrize("how", list(DAMAGE))
def test_damaged_files_rejected_by_both(data, tmp_path, how):
    if how == "measure_rows":
        path = _measure_row_count_file(data, tmp_path)
    else:
        ds = _build("repro_torch", data, "v2_runs")
        path = t_store.save(ds.index, str(tmp_path / "c.ridx"))
        _damage(path, how)
    err, mmaps = DAMAGE[how]
    for store in (r_store, t_store):
        for mmap in mmaps:
            with pytest.raises(getattr(store, err)):
                store.load(path, mmap=mmap)
    if how == "payload_byte":      # the trusting mmap path verifies on ask
        with pytest.raises(t_store.StoreCorruptError):
            t_store.load(path, mmap=True, verify=True)
    rep_r, rep_t = r_store.scrub(path), t_store.scrub(path)
    assert rep_t == rep_r and not rep_t["ok"]


def test_scrub_reports_match_reference(data, tmp_path):
    table, measures = data
    d = str(tmp_path / "s")
    t_dataset.Dataset.from_rows(table, NAMES, shards=3, measures=measures,
                                device="cpu").save(d)
    assert t_store.scrub_sharded(d) == r_store.scrub_sharded(d)
    assert t_store.scrub_sharded(d)["ok"]
    path = os.path.join(d, "shard-00001.ridx")
    with open(path, "r+b") as f:
        f.seek(t_store.PAYLOAD_START + 9)
        b = f.read(1)
        f.seek(t_store.PAYLOAD_START + 9)
        f.write(bytes([b[0] ^ 0x10]))
    rep = t_store.scrub_sharded(d)
    assert rep == r_store.scrub_sharded(d)
    assert not rep["ok"] and rep["n_corrupt_segments"] == 1
    assert [s["ok"] for s in rep["shards"]] == [True, False, True]
    with pytest.raises(t_store.StoreError):
        t_store.load_sharded(str(tmp_path / "nowhere"))
    with pytest.raises(t_store.StoreError):
        t_store.write_shard_file(str(tmp_path), 0, None)


# -- the dense operand cache never aliases the mapped file -------------------

def _file_map(shard):
    """The ``np.memmap`` of a shard's store file, reached through its
    measure sidecar (a view into the same mapping as every bitmap)."""
    a = shard.measures["sales"]
    while not isinstance(a, np.memmap):
        a = a.base
    return a


@pytest.mark.parametrize("sort", ["lex", "none"])
def test_dense_cache_owns_its_memory_on_mmap_open(data, tmp_path, sort):
    table, measures = data
    d = str(tmp_path / sort)
    t_dataset.Dataset.from_rows(table, NAMES, sort=sort, shards=2,
                                measures=measures, device="cpu").save(d)
    ds = t_dataset.Dataset.open(d, mmap=True, device="cpu")
    want = _statements(ds, t_col, "ewah")
    for e in _filters(t_col):
        ds.query(backend="kernel").where(e).count()
    for sh in ds.index.shards:
        mm = _file_map(sh)
        assert not mm.flags.writeable
        assert sh.dense_cache, "the kernel path cached no operand"
        for key, pair in sh.dense_cache.items():
            assert key[1] == "cpu"
            for t in pair:
                assert not np.may_share_memory(t.numpy(), mm), key
        # the executor's own conversion, on one mapped bitmap a column
        for ci in sh.columns:
            bm = ci.bitmaps[0][0]
            cp = 1024 * max(1, -(-bm.n_words_uncompressed // 1024))
            w, f = Executor._pad_and_flags(bm, cp, torch.device("cpu"))
            for t in (w, f):
                assert t.numpy().flags.writeable
                assert not np.may_share_memory(t.numpy(), mm)
            w[0] = w[0] ^ 1      # writable, and the file is untouched
    assert _statements(ds, t_col, "kernel") == want
    again = t_dataset.Dataset.open(d, mmap=True, device="cpu")
    assert _statements(again, t_col, "ewah") == want


def test_open_resolves_the_device_before_any_work(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_dataset.Dataset.open(str(tmp_path / "nowhere"))
    with pytest.raises(t_store.StoreError):
        t_dataset.Dataset.open(str(tmp_path / "nowhere"), device="cpu")
