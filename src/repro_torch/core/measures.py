"""Numeric measure sidecar: interval-sliced reduction in the filtered domain.

The paper's indexes answer *row-set* questions (filter, count, group-count)
entirely in the compressed domain.  A real OLAP workload aggregates numeric
*measures* (sum of sales, average latency) over those row sets.  This module
is the arithmetic half of that subsystem: given a filter's run intervals
(``EWAH.set_intervals()``) and a flat measure array (the store's mmap'd
sidecar), it computes sum/count/min/max — scalar or grouped — by slicing and
reducing the measure array over the intervals, never reconstructing rows.

The key device is the *filtered domain*: the filter's intervals define a
dense coordinate space of exactly ``count(filter)`` positions.  Gathering the
measure values once into that space (``gather``) and prefix-summing them
(``prefix_sums``) turns every per-group sum into two subtractions — a
grouping column's runs (its ``run_catalog``) are found and mapped into
filtered coordinates by the filter's intervals (``probe_catalog``, two
``searchsorted`` probes per filter interval), and ``prefix[end] -
prefix[start]`` is a run's contribution.  Min/max use a segmented
``ufunc.reduceat`` over the same coordinates.  Cost is O(selected rows +
runs met), independent of table width.

Measures are plain 1-D int64 or float64 arrays aligned with the (sorted)
fact table's row order; they ride along through every physical reshaping
(shard cuts, reshard, optimize, compaction) by ordinary slicing and
permutation.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# the only dtypes the sidecar stores: 8-byte little-endian integers/floats
# (fixed width keeps the store layout trivially seekable and mmap views
# zero-copy; anything else is coerced at declaration time or rejected)
MEASURE_DTYPES = ("<i8", "<f8")


def measure_dtype_str(arr: np.ndarray) -> str:
    """Canonical dtype tag (``'<i8'`` / ``'<f8'``) of a measure array."""
    if arr.dtype == np.int64:
        return "<i8"
    if arr.dtype == np.float64:
        return "<f8"
    raise ValueError(f"measure dtype {arr.dtype} is not int64/float64")


def normalize_measures(measures, n_rows: int) -> Dict[str, np.ndarray]:
    """Validate and coerce a ``{name: array}`` measure declaration.

    Integer inputs become int64, floating inputs float64 (the two dtypes
    the store sidecar carries); every array must be 1-D of exactly
    ``n_rows`` values, and names must be non-empty strings.
    """
    out: Dict[str, np.ndarray] = {}
    for name, arr in dict(measures).items():
        if not isinstance(name, str) or not name:
            raise ValueError(f"measure name must be a non-empty string, "
                             f"got {name!r}")
        arr = np.asarray(arr)
        if arr.ndim != 1:
            raise ValueError(f"measure {name!r} must be 1-D, "
                             f"got shape {arr.shape}")
        if len(arr) != n_rows:
            raise ValueError(f"measure {name!r} has {len(arr)} values for "
                             f"{n_rows} rows")
        if np.issubdtype(arr.dtype, np.floating):
            arr = np.ascontiguousarray(arr, dtype=np.float64)
        elif np.issubdtype(arr.dtype, np.integer) \
                or np.issubdtype(arr.dtype, np.bool_):
            arr = np.ascontiguousarray(arr, dtype=np.int64)
        else:
            raise ValueError(f"measure {name!r} has non-numeric dtype "
                             f"{arr.dtype}")
        out[name] = arr
    return out


def min_identity(dtype) -> "int | float":
    """Identity element for elementwise min-merging (empty groups)."""
    return np.inf if np.dtype(dtype).kind == "f" \
        else int(np.iinfo(np.int64).max)


def max_identity(dtype) -> "int | float":
    return -np.inf if np.dtype(dtype).kind == "f" \
        else int(np.iinfo(np.int64).min)


# -- interval machinery ------------------------------------------------------

def interval_positions(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Row ids covered by half-open intervals ``[starts[i], ends[i])``.

    Vectorized expansion: one ``repeat`` + one ``arange`` regardless of the
    interval count — the gather index for slicing a measure array by a
    filter's run intervals.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    lens = ends - starts
    total = int(lens.sum())
    if not total:
        return np.empty(0, dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return np.repeat(starts - offsets, lens) + np.arange(total,
                                                         dtype=np.int64)


def gather(values: np.ndarray, starts: np.ndarray,
           ends: np.ndarray) -> np.ndarray:
    """Measure values over the intervals, concatenated in row order —
    the filtered-domain image of the measure column."""
    return values[interval_positions(starts, ends)]


def run_catalog(intervals: Sequence[Tuple[np.ndarray, np.ndarray]],
                n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """The run-length encoding of a column whose value bitmaps partition
    its ``n_rows`` rows, from each rank's set-bit intervals
    (``intervals[rank]``): the sorted run starts and each run's rank.  A
    run ends where the next one starts, the last at ``n_rows``.  Starts
    are int32 where the rows fit, ranks the narrowest unsigned type."""
    sdt = np.int32 if n_rows < 2 ** 31 else np.int64
    rdt = np.min_scalar_type(len(intervals) - 1)
    starts = np.concatenate([s.astype(sdt) for s, _ in intervals])
    ranks = np.concatenate([np.full(len(s), r, rdt)
                            for r, (s, _) in enumerate(intervals)])
    order = np.argsort(starts)
    return starts[order], ranks[order]


def probe_catalog(starts: np.ndarray, ranks: np.ndarray, n_rows: int,
                  fs: np.ndarray, fe: np.ndarray):
    """The runs of a ``run_catalog`` that the filter intervals ``[fs,
    fe)`` (int64, sorted, disjoint, non-empty) meet, each clipped to its
    interval and mapped into the filtered domain: ``(S, E, R)``, int64,
    sorted by ``S``.  One ``searchsorted`` pair finds each interval's
    first and last run, so the cost is O(F log N + runs met), whatever
    the column's cardinality."""
    first = np.searchsorted(starts, fs.astype(starts.dtype),
                            side="right") - 1
    stop = np.searchsorted(starts, fe.astype(starts.dtype), side="left")
    met = stop - first
    k = interval_positions(first, stop)
    nxt = np.minimum(k + 1, len(starts) - 1)
    run_e = np.where(k + 1 < len(starts), starts[nxt], n_rows)
    lens = fe - fs
    # global row x of interval j sits at x - shift[j] in filtered
    # coordinates, shift[j] being fs[j] less the rows kept before it
    shift = np.repeat(fs - (np.cumsum(lens) - lens), met)
    S = np.maximum(starts[k], np.repeat(fs, met)) - shift
    E = np.minimum(run_e, np.repeat(fe, met)) - shift
    return S, E, ranks[k].astype(np.int64)


def prefix_sums(fvals: np.ndarray) -> np.ndarray:
    """``prefix[j] = sum(fvals[:j])`` with ``prefix[0] = 0`` — every
    contiguous-range sum in the filtered domain becomes one subtraction."""
    out = np.empty(len(fvals) + 1, dtype=fvals.dtype)
    out[0] = 0
    np.cumsum(fvals, out=out[1:])
    return out


def reduce_intervals(values: np.ndarray, starts: np.ndarray,
                     ends: np.ndarray) -> Tuple:
    """Scalar ``(sum, count, min, max)`` of ``values`` over the intervals.

    ``min``/``max`` are ``None`` when the intervals are empty.  Sums use
    the measure's own dtype (int64 sums wrap exactly like a NumPy oracle
    would — bit-exactness over speed-of-light overflow semantics).
    """
    fvals = gather(values, starts, ends)
    count = int(len(fvals))
    if not count:
        zero = 0.0 if values.dtype.kind == "f" else 0
        return zero, 0, None, None
    total = fvals.sum()
    total = float(total) if values.dtype.kind == "f" else int(total)
    mn, mx = fvals.min(), fvals.max()
    if values.dtype.kind == "f":
        return total, count, float(mn), float(mx)
    return total, count, int(mn), int(mx)


def segmented_min_max(fvals: np.ndarray, cs: np.ndarray,
                      ce: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-segment ``min``/``max`` of ``fvals[cs[i]:ce[i])`` for sorted,
    disjoint, *non-empty* segments (``cs < ce`` elementwise).

    Interleaved ``ufunc.reduceat``: indices ``[c0, e0, c1, e1, ...]``
    reduce ``[c0, e0)`` at the even slots.  ``reduceat`` needs every index
    ``< len(fvals)``, so a final ``e == len`` is clipped and the dropped
    last element folded back in (idempotent for min/max).
    """
    n = len(fvals)
    m = len(cs)
    bounds = np.empty(2 * m, dtype=np.int64)
    bounds[0::2] = cs
    bounds[1::2] = ce
    clipped = bounds == n
    if clipped.any():
        bounds = np.where(clipped, n - 1, bounds)
    mins = np.minimum.reduceat(fvals, bounds)[0::2]
    maxs = np.maximum.reduceat(fvals, bounds)[0::2]
    end_clip = clipped[1::2]
    if end_clip.any():
        mins = np.where(end_clip, np.minimum(mins, fvals[-1]), mins)
        maxs = np.where(end_clip, np.maximum(maxs, fvals[-1]), maxs)
    return mins, maxs


# -- partial-aggregate merging (shard / worker fan-in) ----------------------

def merge_scalar_aggs(parts: Sequence[Tuple]) -> Tuple:
    """Merge per-shard ``(sum, count, min, max)`` tuples: sums and counts
    add, mins/maxs combine skipping empty (``None``) shards."""
    total: "int | float" = 0
    count = 0
    mn = None
    mx = None
    for s, c, lo, hi in parts:
        total = total + s
        count += int(c)
        if c:
            mn = lo if mn is None else min(mn, lo)
            mx = hi if mx is None else max(mx, hi)
    return total, count, mn, mx


def merge_group_aggs(parts: Sequence[Dict]) -> Dict:
    """Merge per-shard grouped-aggregate dicts (see
    ``Executor.run_group_agg``): counts and sums add elementwise, mins and
    maxs combine elementwise (empty cells hold their identities, so plain
    ``np.minimum``/``np.maximum`` is the merge)."""
    parts = list(parts)
    ref = parts[0]
    out = {"cols": ref["cols"], "shape": tuple(ref["shape"]),
           "measure": ref.get("measure"), "dtype": ref.get("dtype"),
           "counts": ref["counts"].copy()}
    if ref.get("sums") is not None:
        out["sums"] = ref["sums"].copy()
        out["mins"] = ref["mins"].copy()
        out["maxs"] = ref["maxs"].copy()
    for p in parts[1:]:
        out["counts"] += p["counts"]
        if out.get("sums") is not None:
            out["sums"] += p["sums"]
            np.minimum(out["mins"], p["mins"], out=out["mins"])
            np.maximum(out["maxs"], p["maxs"], out=out["maxs"])
    return out


def empty_group_agg(cols, shape, measure: Optional[str],
                    dtype: Optional[str]) -> Dict:
    """A grouped-aggregate result with every cell empty (the merge
    identity) — what a row-less shard or an all-false filter contributes."""
    size = int(np.prod(shape)) if len(shape) else 0
    out = {"cols": tuple(cols), "shape": tuple(shape),
           "measure": measure, "dtype": dtype,
           "counts": np.zeros(size, dtype=np.int64)}
    if measure is not None:
        vdt = np.dtype(dtype)
        out["sums"] = np.zeros(size, dtype=vdt)
        out["mins"] = np.full(size, min_identity(vdt), dtype=vdt)
        out["maxs"] = np.full(size, max_identity(vdt), dtype=vdt)
    return out


def finalize_scalar(op: str, agg: Tuple):
    """Project one ``(sum, count, min, max)`` partial onto the requested
    statement op; ``avg`` divides at the very top (never per shard), empty
    inputs yield ``None`` for avg/min/max and 0 for sum/count."""
    s, c, mn, mx = agg
    if op == "sum":
        return s
    if op == "count":
        return int(c)
    if op == "avg":
        return (s / c) if c else None
    if op == "min":
        return mn
    if op == "max":
        return mx
    raise ValueError(f"unknown aggregate op {op!r}")


def finalize_group(op: str, agg: Dict) -> np.ndarray:
    """Project a grouped partial onto one op as a flat array; empty cells
    become NaN for avg/min/max (JSON layers render them null)."""
    counts = agg["counts"]
    if op == "count":
        return counts
    sums = agg["sums"]
    empty = counts == 0
    if op == "sum":
        return sums
    if op == "avg":
        out = np.divide(sums.astype(np.float64), counts,
                        out=np.zeros(len(counts), dtype=np.float64),
                        where=~empty)
        out[empty] = np.nan
        return out
    src = agg["mins"] if op == "min" else agg["maxs"]
    if op not in ("min", "max"):
        raise ValueError(f"unknown aggregate op {op!r}")
    out = src.astype(np.float64)
    out[empty] = np.nan
    return out
