"""Checksummed write-ahead log for the live ingest subsystem.

Every mutation of a live dataset (``repro_torch.core.ingest``) is durably
framed here *before* it touches the in-memory delta index or tombstones, so
a crashed service replays the log on warm start and lands on the exact
pre-crash state — bit-identical bitmaps, not just equivalent row sets.

Frame format (all little-endian)::

    +---------+------+-------------+----------+---------------+
    | magic   | kind | payload_len | crc32    | payload bytes |
    | uint32  | u8   | uint32      | uint32   | payload_len   |
    +---------+------+-------------+----------+---------------+

``crc32`` covers the payload only; the magic guards against reading
mid-stream garbage as a header.  Replay accepts the longest valid frame
prefix and stops at the first torn or corrupt frame (short header, short
payload, bad magic, or CRC mismatch) — a crash mid-``write`` therefore
loses at most the frame being written, never an acknowledged one.  Opening
a ``WAL`` for append truncates the file back to that valid prefix, so new
frames always extend acknowledged history.

Record kinds:

* ``KIND_EPOCH`` — JSON ``{"epoch": N}``; written as the first frame of a
  fresh log so replay can cross-check the log against the store manifest
  it belongs to (a stale log from before a compaction must not replay onto
  the compacted base).
* ``KIND_APPEND`` — a row batch: ``(n_rows, n_cols)`` header + raw
  little-endian int64 row-major cells.
* ``KIND_APPENDM`` — a row batch *with measure tails*: a u32-length JSON
  header naming ``n``/``d`` and the ordered measure ``(name, dtype)``
  list, then the raw row cells, then each measure's raw array bytes in
  header order.  Used when the live dataset carries a measure sidecar, so
  replay reconstructs appended measure values bit-exactly.
* ``KIND_DELETE`` — a delete predicate as a JSON wire expression
  (``repro_torch.core.expr.to_wire``).  Deletes are *declarative* in the log:
  replay re-evaluates each predicate against the state reconstructed so
  far, in original order, which reproduces the original tombstones exactly
  (the predicate only sees rows that existed when it was logged).
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

from .expr import Expr, from_wire, to_wire

_MAGIC = 0x314C4157  # b"WAL1" little-endian
_FRAME = struct.Struct("<IBII")
_APPEND_HDR = struct.Struct("<II")

KIND_EPOCH = 1
KIND_APPEND = 2
KIND_DELETE = 3
KIND_APPENDM = 4  # append with measure tails

_APPENDM_HDR = struct.Struct("<I")  # u32 JSON header length


class WALError(Exception):
    """Structurally invalid use of a WAL (not a torn tail — those are
    tolerated by design and silently truncated)."""


# -- payload codecs ---------------------------------------------------------

def encode_epoch(epoch: int) -> bytes:
    return json.dumps({"epoch": int(epoch)}).encode()


def decode_epoch(payload: bytes) -> int:
    return int(json.loads(payload.decode())["epoch"])


def encode_append(rows: np.ndarray) -> bytes:
    rows = np.ascontiguousarray(rows, dtype="<i8")
    if rows.ndim != 2:
        raise WALError(f"append payload must be 2-D, got shape {rows.shape}")
    return _APPEND_HDR.pack(rows.shape[0], rows.shape[1]) + rows.tobytes()


def decode_append(payload: bytes) -> np.ndarray:
    n, d = _APPEND_HDR.unpack_from(payload)
    rows = np.frombuffer(payload, dtype="<i8", offset=_APPEND_HDR.size)
    if len(rows) != n * d:
        raise WALError(f"append payload holds {len(rows)} cells, "
                       f"header says {n}x{d}")
    return rows.reshape(n, d).astype(np.int64)


def encode_append_m(rows: np.ndarray, measures) -> bytes:
    """Row batch + aligned measure arrays (``{name: 1-D array}``)."""
    rows = np.ascontiguousarray(rows, dtype="<i8")
    if rows.ndim != 2:
        raise WALError(f"append payload must be 2-D, got shape {rows.shape}")
    spec = []
    tails = []
    for name, arr in dict(measures).items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.int64:
            dt = "<i8"
        elif arr.dtype == np.float64:
            dt = "<f8"
        else:
            raise WALError(f"measure {name!r} dtype {arr.dtype} is not "
                           f"int64/float64")
        if arr.ndim != 1 or len(arr) != rows.shape[0]:
            raise WALError(f"measure {name!r} has shape {arr.shape} for "
                           f"{rows.shape[0]} rows")
        spec.append([name, dt])
        tails.append(arr.astype(dt, copy=False).tobytes())
    hdr = json.dumps({"n": rows.shape[0], "d": rows.shape[1],
                      "measures": spec}).encode()
    return (_APPENDM_HDR.pack(len(hdr)) + hdr + rows.tobytes()
            + b"".join(tails))


def decode_append_m(payload: bytes):
    """-> ``(rows, {name: array})``."""
    (hlen,) = _APPENDM_HDR.unpack_from(payload)
    off = _APPENDM_HDR.size
    meta = json.loads(payload[off:off + hlen].decode())
    off += hlen
    n, d = int(meta["n"]), int(meta["d"])
    cells = np.frombuffer(payload, dtype="<i8", offset=off, count=n * d)
    off += 8 * n * d
    rows = cells.reshape(n, d).astype(np.int64)
    measures = {}
    for name, dt in meta["measures"]:
        arr = np.frombuffer(payload, dtype=dt, offset=off, count=n)
        off += 8 * n
        measures[name] = arr.astype(np.dtype(dt).newbyteorder("="))
    if off != len(payload):
        raise WALError(f"appendm payload has {len(payload) - off} "
                       f"trailing bytes")
    return rows, measures


def encode_delete(e: Expr) -> bytes:
    return json.dumps(to_wire(e)).encode()


def decode_delete(payload: bytes) -> Expr:
    return from_wire(json.loads(payload.decode()))


def decode_frame(kind: int, payload: bytes):
    """(kind, payload) -> ('epoch', N) | ('append', rows) |
    ('appendm', (rows, measures)) | ('delete', expr)."""
    if kind == KIND_EPOCH:
        return "epoch", decode_epoch(payload)
    if kind == KIND_APPEND:
        return "append", decode_append(payload)
    if kind == KIND_APPENDM:
        return "appendm", decode_append_m(payload)
    if kind == KIND_DELETE:
        return "delete", decode_delete(payload)
    raise WALError(f"unknown WAL record kind {kind}")


# -- replay -----------------------------------------------------------------

def replay(path: str) -> Tuple[List[Tuple[int, bytes]], int]:
    """Parse the longest valid frame prefix of a log file.

    Returns ``(frames, valid_bytes)`` where ``frames`` is a list of
    ``(kind, payload)`` and ``valid_bytes`` is the file offset just past
    the last intact frame — everything beyond it is a torn or corrupt tail
    (crash mid-write, partial page flush) and must be discarded.
    """
    frames: List[Tuple[int, bytes]] = []
    valid = 0
    with open(path, "rb") as f:
        data = f.read()
    pos, n = 0, len(data)
    while pos + _FRAME.size <= n:
        magic, kind, plen, crc = _FRAME.unpack_from(data, pos)
        if magic != _MAGIC:
            break
        end = pos + _FRAME.size + plen
        if end > n:
            break  # torn payload
        payload = data[pos + _FRAME.size:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break  # corrupt payload (bit flip or partial overwrite)
        frames.append((kind, payload))
        valid = end
        pos = end
    return frames, valid


class WAL:
    """Append-only writer over one log file (single-writer).

    Opening an existing file replays it (``self.replayed`` holds the valid
    frames for the caller to apply) and truncates any torn tail so appended
    frames extend acknowledged history.

    **Durability knob** — ``fsync`` controls whether every frame append is
    followed by ``os.fsync`` (default off):

    * ``fsync=False`` (default): frames are flushed to the OS page cache on
      every append.  A crashed *process* replays every acknowledged frame
      (the kernel owns the bytes); an ill-timed *power loss or kernel
      panic* may lose the last few frames — replay still lands on a
      consistent earlier state because the CRC framing truncates the torn
      tail.  This is the throughput mode: ingest-while-serving appends cost
      a memcpy, not a disk round trip.
    * ``fsync=True``: durability before acknowledgement — every frame hits
      stable storage before ``log`` returns.  Appends are gated on device
      flush latency (typically 100x slower on commodity SSDs), which is the
      right trade only when an acknowledged write must survive power loss.

    ``sync=`` is accepted as a backward-compatible alias and wins when
    given explicitly.
    """

    def __init__(self, path: str, fsync: bool = False,
                 sync: "bool | None" = None):
        self.path = path
        self.sync = bool(fsync if sync is None else sync)
        if os.path.exists(path):
            self.replayed, valid = replay(path)
            self._f = open(path, "r+b")
            self._f.truncate(valid)
            self._f.seek(valid)
        else:
            self.replayed = []
            self._f = open(path, "w+b")
        self.n_frames = len(self.replayed)

    # -- writing -----------------------------------------------------------
    def log(self, kind: int, payload: bytes) -> None:
        if self._f is None:
            raise WALError("WAL is closed")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(_FRAME.pack(_MAGIC, kind, len(payload), crc) + payload)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        self.n_frames += 1

    def log_epoch(self, epoch: int) -> None:
        self.log(KIND_EPOCH, encode_epoch(epoch))

    def log_append(self, rows: np.ndarray, measures=None) -> None:
        if measures:
            self.log(KIND_APPENDM, encode_append_m(rows, measures))
        else:
            self.log(KIND_APPEND, encode_append(rows))

    def log_delete(self, e: Expr) -> None:
        self.log(KIND_DELETE, encode_delete(e))

    # -- stats / lifecycle ---------------------------------------------------
    @property
    def size_bytes(self) -> int:
        return 0 if self._f is None else self._f.tell()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
