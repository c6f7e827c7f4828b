"""Length-prefixed, CRC-framed wire protocol for the scatter/gather tier.

The coordinator/worker RPC layer reuses the write-ahead log's framing
discipline (``repro_torch.core.wal``): every message is one frame ::

    +---------+------+-------------+----------+---------------+
    | magic   | kind | payload_len | crc32    | payload bytes |
    | uint32  | u8   | uint32      | uint32   | payload_len   |
    +---------+------+-------------+----------+---------------+

with the CRC covering the payload.  A torn or bit-flipped response is
therefore *detected, never half-applied*: the receiver decodes a payload
only after the whole frame arrived and its checksum passed, and a failure
surfaces as ``WireCorruptError`` — the coordinator treats it exactly like a
dead replica (retry elsewhere), it can never merge a corrupt partial count
into a query answer.

Payloads carry a JSON control object plus an optional raw binary section
for arrays (per-shard count vectors, EWAH words)::

    +-----------+------------+---------------------------+
    | json_len  | json bytes | concatenated array bytes  |
    | uint32    | json_len   | ...                       |
    +-----------+------------+---------------------------+

The JSON object's ``"_arrays"`` entry maps each array name to
``[dtype_str, n_elements]`` in on-wire order, so numeric payloads ship as
raw little-endian bytes instead of JSON numbers.

``FaultInjector`` is the chaos seam threaded through the transport: a
deterministic (seeded) source of drop / delay / corrupt / disconnect
decisions applied at ``send_frame`` time, so every failure mode the
robustness policy claims to handle is exercised by tests and the chaos
benchmark rather than asserted.
"""
from __future__ import annotations

import json
import random
import socket
import struct
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = 0x43505257  # b"WRPC" little-endian
_FRAME = struct.Struct("<IBII")  # magic, kind, payload_len, crc32
_JSON_HDR = struct.Struct("<I")

KIND_REQ = 1
KIND_RESP = 2
KIND_ERR = 3

# Frames above this are rejected before the payload is read — the shared
# request-size guard (HTTP bodies have the analogous --max-body-bytes cap).
DEFAULT_MAX_BYTES = 64 << 20


class WireError(Exception):
    """Protocol-level failure (framing, size, decode)."""


class WireCorruptError(WireError):
    """Bad magic or CRC mismatch — a torn/corrupt frame, retry elsewhere."""


class WireTooLargeError(WireError):
    """Frame exceeds the size cap; refused before reading the payload."""


class WorkerError(WireError):
    """The worker answered with an error frame (its message is carried)."""


# -- message codec -----------------------------------------------------------

def encode_msg(obj: Dict, arrays: Optional[Dict[str, np.ndarray]] = None
               ) -> bytes:
    """JSON control object + named numeric arrays -> one payload blob."""
    arrays = arrays or {}
    meta = {}
    tail = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        # force a little-endian on-wire byte order regardless of host
        dt = arr.dtype.newbyteorder("<")
        arr = arr.astype(dt, copy=False)
        meta[name] = [dt.str, int(arr.size)]
        tail.append(arr.tobytes())
    body = dict(obj)
    if meta:
        body["_arrays"] = meta
    js = json.dumps(body, separators=(",", ":")).encode()
    return _JSON_HDR.pack(len(js)) + js + b"".join(tail)


def decode_msg(payload: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Inverse of ``encode_msg``; raises ``WireError`` on malformed input."""
    if len(payload) < _JSON_HDR.size:
        raise WireError(f"payload of {len(payload)} bytes has no JSON header")
    (jlen,) = _JSON_HDR.unpack_from(payload)
    if _JSON_HDR.size + jlen > len(payload):
        raise WireError(f"JSON section [{jlen} bytes] overruns the payload")
    try:
        obj = json.loads(payload[_JSON_HDR.size:_JSON_HDR.size + jlen])
    except ValueError as exc:
        raise WireError(f"unparseable JSON section: {exc}") from exc
    if not isinstance(obj, dict):
        raise WireError(f"JSON section must be an object, got {type(obj)}")
    arrays: Dict[str, np.ndarray] = {}
    pos = _JSON_HDR.size + jlen
    for name, (dt, n) in (obj.pop("_arrays", None) or {}).items():
        nbytes = np.dtype(dt).itemsize * int(n)
        if pos + nbytes > len(payload):
            raise WireError(f"array {name!r} overruns the payload")
        arrays[name] = np.frombuffer(payload, dtype=dt, count=int(n),
                                     offset=pos)
        pos += nbytes
    return obj, arrays


# -- fault injection ---------------------------------------------------------

class FaultInjector:
    """Deterministic (seeded) transport-fault source.

    Each ``action()`` draw picks at most one fault, by cumulative
    probability: ``drop`` (never send the response — the peer's deadline
    fires), ``delay`` (sleep ``delay_s`` before sending — exercises hedged
    requests), ``corrupt`` (flip one payload byte *after* the CRC is
    computed — the peer must detect it), ``disconnect`` (close the socket
    mid-exchange).  The same seed always yields the same fault sequence, so
    chaos tests are reproducible run to run.
    """

    def __init__(self, seed: int = 0, drop: float = 0.0, delay: float = 0.0,
                 corrupt: float = 0.0, disconnect: float = 0.0,
                 delay_s: float = 0.25):
        self.seed = int(seed)
        self.drop = float(drop)
        self.delay = float(delay)
        self.corrupt = float(corrupt)
        self.disconnect = float(disconnect)
        self.delay_s = float(delay_s)
        self._rng = random.Random(self.seed)
        self.counts: Dict[str, int] = {"drop": 0, "delay": 0, "corrupt": 0,
                                       "disconnect": 0, "none": 0}

    @classmethod
    def from_config(cls, cfg: Optional[Dict]) -> Optional["FaultInjector"]:
        if not cfg:
            return None
        return cls(**{k: cfg[k] for k in
                      ("seed", "drop", "delay", "corrupt", "disconnect",
                       "delay_s") if k in cfg})

    def to_config(self) -> Dict:
        return {"seed": self.seed, "drop": self.drop, "delay": self.delay,
                "corrupt": self.corrupt, "disconnect": self.disconnect,
                "delay_s": self.delay_s}

    def action(self) -> Optional[str]:
        r = self._rng.random()
        for name in ("drop", "delay", "corrupt", "disconnect"):
            p = getattr(self, name)
            if r < p:
                self.counts[name] += 1
                return name
            r -= p
        self.counts["none"] += 1
        return None

    def corrupt_at(self, n: int) -> int:
        return self._rng.randrange(max(n, 1))


# -- framing over a socket ---------------------------------------------------

def send_frame(sock: socket.socket, kind: int, payload: bytes,
               injector: Optional[FaultInjector] = None) -> Optional[str]:
    """Send one frame; returns the injected fault action (or None).

    The CRC is always computed over the *original* payload, so a ``corrupt``
    injection produces exactly the failure a real bit flip would: a frame
    whose checksum no longer matches its bytes.
    """
    action = injector.action() if injector is not None else None
    if action == "drop":
        return action
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if action == "corrupt" and payload:
        flipped = bytearray(payload)
        flipped[injector.corrupt_at(len(payload))] ^= 0xFF
        payload = bytes(flipped)
    if action == "delay":
        time.sleep(injector.delay_s)
    if action == "disconnect":
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()
        return action
    sock.sendall(_FRAME.pack(_MAGIC, kind, len(payload), crc) + payload)
    return action


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    chunks = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("wire deadline exceeded")
            sock.settimeout(remaining)
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket, deadline: Optional[float] = None,
               max_bytes: int = DEFAULT_MAX_BYTES) -> Tuple[int, bytes]:
    """Read one frame; validates magic, size cap and CRC before returning.

    ``deadline`` is an absolute ``time.monotonic()`` instant shared across
    however many reads the frame needs (a slow-loris peer cannot reset it).
    Raises ``socket.timeout`` / ``ConnectionError`` on transport failures
    and ``WireCorruptError`` on framing violations — the caller never sees
    a partially-validated payload.
    """
    hdr = _recv_exact(sock, _FRAME.size, deadline)
    magic, kind, plen, crc = _FRAME.unpack(hdr)
    if magic != _MAGIC:
        raise WireCorruptError(f"bad frame magic {magic:#x}")
    if plen > max_bytes:
        raise WireTooLargeError(f"frame payload of {plen} bytes exceeds the "
                                f"{max_bytes}-byte cap")
    payload = _recv_exact(sock, plen, deadline)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise WireCorruptError("frame checksum mismatch (torn or corrupt "
                               "response)")
    return kind, payload


def call(sock: socket.socket, obj: Dict,
         arrays: Optional[Dict[str, np.ndarray]] = None,
         deadline: Optional[float] = None,
         max_bytes: int = DEFAULT_MAX_BYTES
         ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """One request/response exchange; raises ``WorkerError`` on error frames."""
    send_frame(sock, KIND_REQ, encode_msg(obj, arrays))
    kind, payload = recv_frame(sock, deadline=deadline, max_bytes=max_bytes)
    out, arrs = decode_msg(payload)
    if kind == KIND_ERR:
        raise WorkerError(out.get("error", "unknown worker error"))
    if kind != KIND_RESP:
        raise WireError(f"unexpected frame kind {kind}")
    return out, arrs
