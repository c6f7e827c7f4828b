"""Durable, versioned, memory-mapped index store.

The on-disk format makes the paper's storage premise real — bitmap indexes
"rely mostly on sequential input/output" — by laying every EWAH word stream
out contiguously and 32-bit-word aligned, so an index opens by *mapping* the
file, not parsing it (the Roaring line's zero-parse lesson, arXiv:1402.6407):

    offset  size  field
    0       8     magic  b"REPROIDX"
    8       4     format version (uint32 LE)
    12      4     flags (reserved, 0)
    16      8     header offset (uint64 LE, patched at close)
    24      8     header length (uint64 LE)
    32      4     header CRC32 (uint32 LE)
    36      28    zero padding (payload starts 64-byte aligned)
    64      ...   payload: concatenated EWAH word segments, each a raw
                  little-endian uint32 array, 4-byte aligned
    hdr_off ...   JSON header (metadata + per-column TOC, see below)

The JSON header records ``n_rows``, ``partition_bounds``, ``column_names``,
per-column encoder parameters (card / k / allocation / L), and a TOC:
``toc[col][partition][bitmap_id] == [byte_offset, n_words, crc32]``.  The
header lives *after* the payload so ``StoreWriter`` can stream partitions to
disk as a builder closes them — nothing is buffered beyond the TOC itself —
and the preamble is patched last, then the temp file atomically renamed into
place: a crashed writer never leaves a file that passes validation.

``load(path, mmap=True)`` returns a ``BitmapIndex`` whose ``EWAH.words`` are
read-only ``np.memmap`` views straight into the file — zero-copy, no word
touched until a query touches it; the run-list decode memoization layers on
top unchanged.  ``mmap=False`` reads the payload into memory and verifies
every segment checksum (``verify`` overrides either default).

A *sharded* index is a directory: one store file per shard plus a
``manifest.json`` naming them in row order.  ``write_shard_file`` replaces a
single shard atomically (write-temp + ``os.replace``), which is what makes
incremental reindex safe under live readers: an open mmap keeps the old
inode alive, and any fresh ``load`` sees either the old or the new file,
never a torn one.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from .encoding import ColumnEncoder
from .ewah import EWAH, WORD_DTYPE
from .index import BitmapIndex, ColumnIndex

MAGIC = b"REPROIDX"
VERSION = 2            # v2: container-tagged segments (TOC entries grow a
                       # 4th element; tag 0 / absent = raw EWAH words, tag 1
                       # = hybrid-container blob).  v1 files read unchanged.
VERSION_REMAP = 3      # v3: column metadata may carry a "remap" permutation
                       # (frequency-remapped value encoding).  Only written
                       # when a remap is present — an old build must refuse
                       # the file rather than silently decode wrong values.
VERSION_MEASURES = 4   # v4: a columnar numeric measure sidecar rides after
                       # the bitmap payload (header key "measures", segment
                       # kind SEG_MEASURES).  Only written when measures are
                       # present, so measure-free builds stay byte-identical
                       # v2/v3 files.
COMPAT_VERSIONS = (1, 2, 3, 4)
SEG_EWAH = 0
SEG_CONTAINERS = 1
SEG_MEASURES = 2
_PREAMBLE = struct.Struct("<8sIIQQI")  # magic, version, flags, off, len, crc
PAYLOAD_START = 64  # 64-byte aligned payload keeps every segment word-aligned

MANIFEST_NAME = "manifest.json"
SHARD_FILE_FMT = "shard-{:05d}.ridx"


class StoreError(Exception):
    """Base class for store format violations."""


def _fsync_dir(dir_path: str) -> None:
    """Flush a directory entry so an atomic rename survives power loss."""
    try:
        fd = os.open(dir_path or ".", os.O_RDONLY)
    except OSError:  # e.g. platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class StoreVersionError(StoreError):
    """File carries an unknown magic or format version."""


class StoreCorruptError(StoreError):
    """File is truncated or fails a checksum."""


def _encoder_meta(enc: ColumnEncoder) -> Dict:
    meta = {"card": enc.card, "k": enc.k,
            "allocation": enc.allocation, "L": enc.L}
    if enc.remap is not None:
        meta["remap"] = [int(v) for v in enc.remap]
    return meta


class StoreWriter:
    """Streaming writer: partitions in, one durable store file out.

    ``add_partition`` appends every bitmap's words to the payload as soon as
    the partition closes — the natural sink for ``IndexBuilder``, which then
    never holds more than one partition of bitmaps in memory.  ``close``
    writes the JSON header + TOC, patches the preamble, fsyncs and atomically
    renames the temp file over ``path``.
    """

    def __init__(self, path: str, encoders: Sequence[ColumnEncoder],
                 column_names: Optional[Sequence[str]] = None,
                 measures: Optional[Dict[str, str]] = None):
        self.path = str(path)
        self._tmp = f"{self.path}.tmp.{os.getpid()}"
        self._encoders = list(encoders)
        self._names = list(column_names) if column_names is not None else None
        self._f = open(self._tmp, "wb")
        self._f.write(b"\0" * PAYLOAD_START)  # preamble patched at close
        self._pos = PAYLOAD_START
        # toc[col][partition][bitmap] = [offset, n_words, crc32]
        self._toc: List[List[List[List[int]]]] = [[] for _ in self._encoders]
        self._bounds: List[int] = [0]
        # measure sidecar: per-partition arrays are buffered and written
        # contiguously per measure at close, so each measure mmap-opens as
        # one zero-copy view spanning every partition
        self._measures: Dict[str, Dict] = {}
        if measures:
            from .measures import MEASURE_DTYPES
            for name, dt in measures.items():
                if dt not in MEASURE_DTYPES:
                    raise ValueError(
                        f"measure {name!r} dtype {dt!r} not in "
                        f"{MEASURE_DTYPES}")
                self._measures[name] = {"dtype": dt, "parts": []}
        self._closed = False

    def add_partition(self, bitmaps_per_column: Sequence[Sequence[EWAH]],
                      rows_part: int,
                      measures_part: Optional[Dict] = None) -> None:
        assert not self._closed
        if len(bitmaps_per_column) != len(self._encoders):
            raise ValueError(
                f"partition has {len(bitmaps_per_column)} columns, writer "
                f"expects {len(self._encoders)}")
        if set(measures_part or {}) != set(self._measures):
            raise ValueError(
                f"partition carries measures {sorted(measures_part or {})}, "
                f"writer declared {sorted(self._measures)}")
        for name, spec in self._measures.items():
            arr = np.ascontiguousarray(measures_part[name],
                                       dtype=spec["dtype"])
            if arr.ndim != 1 or len(arr) != rows_part:
                raise ValueError(
                    f"measure {name!r} partition has shape {arr.shape} for "
                    f"{rows_part} rows")
            spec["parts"].append(arr)
        for c, (enc, bms) in enumerate(zip(self._encoders,
                                           bitmaps_per_column)):
            if len(bms) != enc.L:
                raise ValueError(
                    f"column {c} partition has {len(bms)} bitmaps, encoder "
                    f"needs {enc.L}")
            entries = []
            for bm in bms:
                if bm.n_bits != rows_part:
                    raise ValueError(
                        f"bitmap over {bm.n_bits} bits in a {rows_part}-row "
                        f"partition")
                # container-backed bitmaps persist their chunk directory +
                # payloads verbatim (no round-trip through the RLE codec);
                # plain bitmaps keep the v1 raw-word layout and a 3-element
                # TOC entry, so sorted batch builds stay byte-compatible
                if bm._cont is not None and bm._words is None:
                    raw = np.ascontiguousarray(bm._cont.serialize(),
                                               dtype=WORD_DTYPE)
                    tag = SEG_CONTAINERS
                else:
                    raw = np.ascontiguousarray(bm.words, dtype=WORD_DTYPE)
                    tag = SEG_EWAH
                data = raw.tobytes()
                entry = [self._pos, len(raw), zlib.crc32(data) & 0xFFFFFFFF]
                if tag != SEG_EWAH:
                    entry.append(tag)
                entries.append(entry)
                self._f.write(data)
                self._pos += len(data)
            self._toc[c].append(entries)
        self._bounds.append(self._bounds[-1] + int(rows_part))

    def close(self) -> str:
        assert not self._closed
        meta = {
            "n_rows": self._bounds[-1],
            "partition_bounds": self._bounds,
            "column_names": self._names,
            "columns": [_encoder_meta(e) for e in self._encoders],
            "toc": self._toc,
        }
        if self._measures:
            # 8-byte-align the sidecar (bitmap segments are only 4-aligned)
            # so every measure element view is naturally aligned; segments
            # of one measure are adjacent, so the whole column is one view
            pad = (-self._pos) % 8
            if pad:
                self._f.write(b"\0" * pad)
                self._pos += pad
            msec: Dict[str, Dict] = {}
            for name, spec in self._measures.items():
                rows = []
                for arr in spec["parts"]:
                    data = arr.tobytes()
                    rows.append([self._pos, len(arr),
                                 zlib.crc32(data) & 0xFFFFFFFF])
                    self._f.write(data)
                    self._pos += len(data)
                if len(rows) != len(self._bounds) - 1:
                    raise ValueError(
                        f"measure {name!r} covers {len(rows)} partitions, "
                        f"bitmaps cover {len(self._bounds) - 1}")
                msec[name] = {"dtype": spec["dtype"], "toc": rows}
            meta["measures"] = msec
        header = json.dumps(meta, separators=(",", ":")).encode()
        hdr_off = self._pos
        self._f.write(header)
        self._f.seek(0)
        if self._measures:
            version = VERSION_MEASURES
        elif any(e.remap is not None for e in self._encoders):
            version = VERSION_REMAP
        else:
            version = VERSION
        self._f.write(_PREAMBLE.pack(MAGIC, version, 0, hdr_off,
                                     len(header), zlib.crc32(header)))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)  # atomic: never a half-written store
        _fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        self._closed = True
        return self.path

    def abort(self) -> None:
        if not self._closed:
            self._closed = True
            self._f.close()
            try:
                os.unlink(self._tmp)
            except OSError:
                pass

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, exc_type, *_exc):
        if exc_type is not None:
            self.abort()
        elif not self._closed:
            self.close()


def save(index: BitmapIndex, path: str) -> str:
    """Write a finished in-memory index as one store file (atomic)."""
    from .measures import measure_dtype_str
    idx_measures = getattr(index, "measures", None) or {}
    spec = {name: measure_dtype_str(np.asarray(arr))
            for name, arr in idx_measures.items()}
    writer = StoreWriter(path, [c.encoder for c in index.columns],
                         index.column_names, measures=spec or None)
    try:
        bounds = index.partition_bounds
        for p in range(index.n_partitions):
            s, e = int(bounds[p]), int(bounds[p + 1])
            mpart = {name: np.asarray(arr)[s:e]
                     for name, arr in idx_measures.items()} or None
            writer.add_partition([col.bitmaps[p] for col in index.columns],
                                 e - s, measures_part=mpart)
        return writer.close()
    except BaseException:
        writer.abort()
        raise


def _parse_header(data: np.ndarray, path: str) -> Dict:
    """Validate preamble + header out of the (mapped or read) file bytes.

    All reads come from ``data`` — one open of one inode — so a concurrent
    atomic shard replacement can never mix one file's header with another's
    payload; a loader sees the old store or the new one, whole.
    """
    size = int(data.size)
    if size < PAYLOAD_START:
        raise StoreCorruptError(f"{path}: {size} bytes, shorter than the "
                                f"{PAYLOAD_START}-byte preamble")
    magic, version, _flags, hdr_off, hdr_len, hdr_crc = \
        _PREAMBLE.unpack(data[:_PREAMBLE.size].tobytes())
    if magic != MAGIC:
        raise StoreVersionError(f"{path}: bad magic {magic!r}")
    if version not in COMPAT_VERSIONS:
        raise StoreVersionError(
            f"{path}: format version {version}, this build reads "
            f"{sorted(COMPAT_VERSIONS)}")
    if hdr_off + hdr_len > size:
        raise StoreCorruptError(
            f"{path}: header [{hdr_off}, {hdr_off + hdr_len}) past EOF "
            f"({size} bytes) — truncated file")
    raw = data[hdr_off:hdr_off + hdr_len].tobytes()
    if (zlib.crc32(raw) & 0xFFFFFFFF) != hdr_crc:
        raise StoreCorruptError(f"{path}: header checksum mismatch")
    try:
        meta = json.loads(raw)
    except ValueError as exc:
        raise StoreCorruptError(f"{path}: unparseable header: {exc}") from exc
    meta["_header_off"] = hdr_off
    meta["_file_size"] = size
    return meta


def load(path: str, mmap: bool = True,
         verify: Optional[bool] = None) -> BitmapIndex:
    """Open a store file as a ``BitmapIndex``.

    ``mmap=True`` (the warm-start path) wraps every bitmap in a read-only
    memmap view — open time is O(TOC), no payload page is read until a query
    touches it.  ``verify`` forces (or skips) per-segment CRC checks; the
    default verifies on the in-memory path and trusts the mapped payload on
    the mmap path (header and TOC bounds are *always* validated, so
    truncation is caught either way).
    """
    if mmap:
        try:
            data = np.memmap(path, dtype=np.uint8, mode="r")
        except (ValueError, OSError) as exc:
            raise StoreCorruptError(f"{path}: cannot map: {exc}") from exc
    else:
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
    meta = _parse_header(data, path)
    if verify is None:
        verify = not mmap
    payload_end = meta["_header_off"]
    encoders = []
    for c, cm in enumerate(meta["columns"]):
        enc = ColumnEncoder(cm["card"], cm["k"], cm["allocation"],
                            remap=cm.get("remap"))
        if enc.L != cm["L"]:
            raise StoreCorruptError(
                f"{path}: column {c} encoder derives L={enc.L} but the file "
                f"records L={cm['L']}")
        encoders.append(enc)
    bounds = np.asarray(meta["partition_bounds"], dtype=np.int64)
    toc = meta["toc"]
    if len(toc) != len(encoders):
        raise StoreCorruptError(f"{path}: TOC covers {len(toc)} columns for "
                                f"{len(encoders)} encoders")
    columns: List[ColumnIndex] = []
    for c, enc in enumerate(encoders):
        if len(toc[c]) != len(bounds) - 1:
            raise StoreCorruptError(
                f"{path}: column {c} TOC has {len(toc[c])} partitions, "
                f"bounds imply {len(bounds) - 1}")
        parts: List[List[EWAH]] = []
        for p, entries in enumerate(toc[c]):
            rows_part = int(bounds[p + 1] - bounds[p])
            if len(entries) != enc.L:
                raise StoreCorruptError(
                    f"{path}: column {c} partition {p} TOC has "
                    f"{len(entries)} bitmaps, encoder needs {enc.L}")
            bms = []
            for b, entry in enumerate(entries):
                off, n_words, crc = entry[:3]
                tag = entry[3] if len(entry) > 3 else SEG_EWAH
                end = off + 4 * n_words
                if off < PAYLOAD_START or end > payload_end or off % 4:
                    raise StoreCorruptError(
                        f"{path}: segment (col {c}, part {p}, bitmap {b}) "
                        f"spans [{off}, {end}), outside the word-aligned "
                        f"payload [{PAYLOAD_START}, {payload_end})")
                words = data[off:end].view(WORD_DTYPE)
                if verify and (zlib.crc32(words.tobytes()) & 0xFFFFFFFF) != crc:
                    raise StoreCorruptError(
                        f"{path}: checksum mismatch in segment (col {c}, "
                        f"part {p}, bitmap {b})")
                if tag == SEG_CONTAINERS:
                    # array/dense payloads stay zero-copy views into the
                    # mapped blob; run payloads decode lazily on first use
                    from .containers import Containers
                    bms.append(EWAH._from_containers(
                        Containers.deserialize(words, rows_part), rows_part))
                elif tag == SEG_EWAH:
                    bms.append(EWAH(words, rows_part))
                else:
                    raise StoreVersionError(
                        f"{path}: segment (col {c}, part {p}, bitmap {b}) "
                        f"carries unknown container tag {tag}")
            parts.append(bms)
        columns.append(ColumnIndex(encoder=enc, bitmaps=parts))
    measures = _load_measures(data, meta, path, verify=verify)
    names = meta["column_names"]
    return BitmapIndex(n_rows=int(meta["n_rows"]), columns=columns,
                       partition_bounds=bounds,
                       column_names=list(names) if names else None,
                       measures=measures)


def _load_measures(data: np.ndarray, meta: Dict, path: str,
                   verify: bool) -> Optional[Dict[str, np.ndarray]]:
    """Open the v4 measure sidecar as zero-copy views into ``data``.

    The measure TOC is cross-checked against the *bitmap* geometry: every
    partition's element count must equal that partition's row count and the
    total must equal ``n_rows`` — a sidecar that disagrees with the bitmaps
    would silently misalign every aggregate, so it is rejected outright.
    """
    msec = meta.get("measures")
    if not msec:
        return None
    from .measures import MEASURE_DTYPES
    bounds = meta["partition_bounds"]
    payload_end = meta["_header_off"]
    n_rows = int(meta["n_rows"])
    out: Dict[str, np.ndarray] = {}
    for name, spec in msec.items():
        dt = spec.get("dtype")
        if dt not in MEASURE_DTYPES:
            raise StoreVersionError(
                f"{path}: measure {name!r} carries unknown dtype {dt!r}")
        rows = spec.get("toc") or []
        if len(rows) != len(bounds) - 1:
            raise StoreCorruptError(
                f"{path}: measure {name!r} TOC has {len(rows)} partitions, "
                f"bitmaps have {len(bounds) - 1}")
        total = 0
        views = []
        for p, (off, n_elems, crc) in enumerate(rows):
            rows_part = int(bounds[p + 1]) - int(bounds[p])
            if n_elems != rows_part:
                raise StoreCorruptError(
                    f"{path}: measure {name!r} partition {p} holds "
                    f"{n_elems} values for {rows_part} bitmap rows — "
                    f"sidecar disagrees with the index")
            end = off + 8 * n_elems
            if off < PAYLOAD_START or end > payload_end or off % 8:
                raise StoreCorruptError(
                    f"{path}: measure {name!r} partition {p} spans "
                    f"[{off}, {end}), outside the aligned payload")
            seg = data[off:end]
            if verify and (zlib.crc32(seg.tobytes()) & 0xFFFFFFFF) != crc:
                raise StoreCorruptError(
                    f"{path}: checksum mismatch in measure {name!r} "
                    f"partition {p}")
            views.append(seg.view(dt))
            total += int(n_elems)
        if total != n_rows:
            raise StoreCorruptError(
                f"{path}: measure {name!r} holds {total} values for "
                f"{n_rows} rows — sidecar disagrees with the index")
        if not views:
            out[name] = np.empty(0, dtype=dt)
        elif len(views) == 1:
            out[name] = views[0]
        elif all(rows[p + 1][0] == rows[p][0] + 8 * rows[p][1]
                 for p in range(len(rows) - 1)):
            # the writer lays one measure's partitions adjacently, so the
            # whole column stays a single zero-copy view into the map
            first = rows[0][0]
            out[name] = data[first:first + 8 * n_rows].view(dt)
        else:
            out[name] = np.concatenate(views) if views \
                else np.empty(0, dtype=dt)
    return out


# ---------------------------------------------------------------------------
# Sharded layout: a directory of per-shard store files + a manifest.
# ---------------------------------------------------------------------------

def shard_path(dir_path: str, i: int) -> str:
    return os.path.join(dir_path, SHARD_FILE_FMT.format(i))


def _write_manifest(dir_path: str, shard_files: List[str],
                    column_names: Optional[Sequence[str]],
                    meta: Optional[Dict] = None) -> None:
    body = json.dumps({
        "version": VERSION,
        "shards": shard_files,
        "column_names": list(column_names) if column_names else None,
        "meta": meta or {},
    }, indent=1).encode()
    tmp = os.path.join(dir_path, f".{MANIFEST_NAME}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dir_path, MANIFEST_NAME))
    _fsync_dir(dir_path)


def save_sharded(index, dir_path: str, meta: Optional[Dict] = None,
                 prefix: str = "") -> str:
    """Write a ``ShardedIndex`` (or a 1-shard ``BitmapIndex``) as a
    directory of atomic per-shard store files plus a manifest.

    ``meta`` (JSON-serializable) is carried verbatim in the manifest —
    the ``Dataset`` façade records its build recipe (sort order, cards,
    encoding) there so ``Dataset.open`` can restore it.

    ``prefix`` is prepended to every shard filename.  The manifest records
    the actual names, so loaders need no convention — live-ingest
    compaction writes each new epoch's shards under an epoch prefix, and
    the manifest rewrite at the end is the atomic cutover between the old
    and new file sets (a crash in between leaves the old manifest naming
    the old, untouched files)."""
    from .shard import ShardedIndex  # local: shard imports store lazily too
    os.makedirs(dir_path, exist_ok=True)
    shards = index.shards if isinstance(index, ShardedIndex) else [index]
    names = index.column_names
    files = []
    for i, sh in enumerate(shards):
        fname = f"{prefix}{SHARD_FILE_FMT.format(i)}"
        save(sh, os.path.join(dir_path, fname))
        files.append(fname)
    _write_manifest(dir_path, files, names, meta)
    return dir_path


def manifest_meta(dir_path: str) -> Dict:
    """The free-form ``meta`` block of a sharded store's manifest
    (``{}`` for directories written before metadata existed)."""
    return _read_manifest(dir_path).get("meta") or {}


def write_shard_file(dir_path: str, i: int, shard: BitmapIndex) -> str:
    """Atomically replace shard ``i``'s store file (write-temp + rename).

    The file-level half of incremental reindex: readers holding the old
    mmap keep serving the old inode; ``ShardedIndex.load`` / ``reload``
    picks up the new file whole or not at all.
    """
    if not os.path.exists(os.path.join(dir_path, MANIFEST_NAME)):
        raise StoreError(f"{dir_path} has no {MANIFEST_NAME}; save the "
                         f"sharded index first")
    names = _read_manifest(dir_path)["shards"]
    if not (0 <= i < len(names)):
        raise StoreError(f"{dir_path}: shard {i} out of range "
                         f"(manifest names {len(names)} shards)")
    # resolve through the manifest, not the naming convention: compacted
    # directories carry epoch-prefixed shard filenames
    return save(shard, os.path.join(dir_path, names[i]))


def _read_manifest(dir_path: str) -> Dict:
    manifest_path = os.path.join(dir_path, MANIFEST_NAME)
    try:
        with open(manifest_path, "rb") as f:
            manifest = json.loads(f.read())
    except OSError as exc:
        raise StoreError(f"{dir_path}: no readable {MANIFEST_NAME} "
                         f"({exc})") from exc
    except ValueError as exc:
        raise StoreCorruptError(
            f"{manifest_path}: unparseable manifest: {exc}") from exc
    if manifest.get("version") not in COMPAT_VERSIONS:
        raise StoreVersionError(
            f"{manifest_path}: manifest version {manifest.get('version')}, "
            f"this build reads {sorted(COMPAT_VERSIONS)}")
    return manifest


def load_sharded(dir_path: str, mmap: bool = True,
                 verify: Optional[bool] = None, **shard_kwargs):
    """Open a sharded store directory as a ``ShardedIndex``.

    Extra keyword arguments (e.g. ``cache_entries`` / ``cache_bytes``) are
    forwarded to the ``ShardedIndex`` constructor."""
    from .shard import ShardedIndex
    manifest = _read_manifest(dir_path)
    shards = [load(os.path.join(dir_path, name), mmap=mmap, verify=verify)
              for name in manifest["shards"]]
    return ShardedIndex(shards, column_names=manifest.get("column_names"),
                        **shard_kwargs)


def manifest_shards(dir_path: str) -> List[str]:
    """Shard store filenames in row order, as the manifest records them
    (compacted directories carry epoch-prefixed names, so callers must
    resolve through here, never through the naming convention)."""
    return list(_read_manifest(dir_path)["shards"])


def scrub(path: str) -> Dict:
    """Explicit full CRC pass over every segment of one store file.

    The mmap load path (``load(path, mmap=True)``) validates the preamble,
    header checksum and TOC bounds but deliberately *skips* per-segment CRC
    verification — paging in every word would defeat the zero-copy open.
    ``scrub`` is the operator-facing audit that closes that gap: it walks
    the TOC and checksums every segment through the page cache (usable on a
    file the serving process has mmap-opened — same inode, shared pages).

    Corrupt segments are *reported, not fatal*: the return dict lists each
    failing ``(col, partition, bitmap)`` with its reason, and an unreadable
    file or header yields ``{"ok": False, "error": ...}`` instead of an
    exception, so a sharded scrub can keep auditing sibling shards.
    """
    out: Dict = {"path": path, "ok": False, "n_segments": 0, "corrupt": []}
    try:
        data = np.memmap(path, dtype=np.uint8, mode="r")
        meta = _parse_header(data, path)
    except (StoreError, OSError, ValueError) as exc:
        out["error"] = str(exc)
        return out
    payload_end = meta["_header_off"]
    for c, col_toc in enumerate(meta.get("toc", [])):
        for p, entries in enumerate(col_toc):
            for b, entry in enumerate(entries):
                off, n_words, crc = entry[:3]
                out["n_segments"] += 1
                end = off + 4 * n_words
                if off < PAYLOAD_START or end > payload_end or off % 4:
                    out["corrupt"].append(
                        {"col": c, "partition": p, "bitmap": b,
                         "offset": int(off), "n_words": int(n_words),
                         "reason": "segment outside the payload"})
                    continue
                words = data[off:end]
                if (zlib.crc32(words.tobytes()) & 0xFFFFFFFF) != crc:
                    out["corrupt"].append(
                        {"col": c, "partition": p, "bitmap": b,
                         "offset": int(off), "n_words": int(n_words),
                         "reason": "checksum mismatch"})
    for name, spec in (meta.get("measures") or {}).items():
        for p, (off, n_elems, crc) in enumerate(spec.get("toc") or []):
            out["n_segments"] += 1
            end = off + 8 * n_elems
            if off < PAYLOAD_START or end > payload_end or off % 8:
                out["corrupt"].append(
                    {"measure": name, "partition": p, "offset": int(off),
                     "n_elems": int(n_elems),
                     "reason": "measure segment outside the payload"})
                continue
            if (zlib.crc32(data[off:end].tobytes()) & 0xFFFFFFFF) != crc:
                out["corrupt"].append(
                    {"measure": name, "partition": p, "offset": int(off),
                     "n_elems": int(n_elems),
                     "reason": "measure checksum mismatch"})
    out["ok"] = not out["corrupt"]
    return out


def scrub_sharded(dir_path: str) -> Dict:
    """CRC-audit every shard file of a sharded store directory.

    Per-shard reports (see ``scrub``) — one corrupt or unreadable shard
    never aborts the audit of its siblings."""
    names = manifest_shards(dir_path)
    shards = []
    for i, name in enumerate(names):
        rep = scrub(os.path.join(dir_path, name))
        rep["shard"] = i
        rep["file"] = name
        shards.append(rep)
    return {"dir": dir_path, "ok": all(s["ok"] for s in shards),
            "n_shards": len(shards),
            "n_corrupt_segments": sum(len(s["corrupt"]) for s in shards),
            "shards": shards}


def shard_fingerprints(dir_path: str) -> List[tuple]:
    """(name, mtime_ns, size) per shard file — the change detector behind
    ``/admin/reload``: a rename updates both fields atomically."""
    manifest = _read_manifest(dir_path)
    out = []
    for name in manifest["shards"]:
        try:
            st = os.stat(os.path.join(dir_path, name))
        except OSError as exc:
            raise StoreError(
                f"{dir_path}: shard file {name} unreadable ({exc})") from exc
        out.append((name, st.st_mtime_ns, st.st_size))
    return out
