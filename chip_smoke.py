#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` with
``nvcc`` (one process per source, all started together), holds each kernel
against its plain PyTorch version on the card at its main path's shapes and
times kernel, plain version and the PyTorch library call, then drives the
port's main paths through the entry points a user calls:

1. the bitmap engine, ``logical_reduce`` (the fused n-ary AND / OR and
   AND-NOT of the executor's dense path):

    Dataset.from_rows(rows, names, sort=..., measures=..., device="cuda")
        .query(backend=...).where(e) -> count / group_by / top_k /
                                        sum / avg / min / max / rows

   on the paper's section 4.1 uniform table (4 columns of cardinality 100,
   200, 400 and 800; 2^22 rows sorted, 2^21 rows unsorted), under the
   ``ewah``, ``kernel`` and ``auto`` backends.  The three backends must
   agree and every answer must match a NumPy oracle over the same rows;
   ``ewah`` must launch no kernel, ``kernel`` the fused one.  The fused
   kernel is then checked and timed on the main path's own operands.

   The index profile, ``bitpack``, ``popcount_rows``, ``popcount_total``
   and the pairwise ``word_logical`` through ``repro_torch.kernels.ops``,
   over the sorted table's Dataset: the (2^22, 1,500) bools of its rows
   pack into words that must equal the index's 1,500 bitmaps; each
   bitmap's count must equal ``bitmap_count`` and the total 4 x 2^22;
   2^31 set bits must wrap to -2^31 as the reference's int32 sum does;
   the OR of 32 bitmaps with 32 others must equal ``a | b``.

2. Durability and scale over the same kernel, ``logical_reduce``: both
   tables built again with 4 word-aligned row shards (all on the one
   card), saved to the index store, reopened from the memory-mapped
   files with ``Dataset.open(dir, mmap=True, device="cuda")`` and driven
   under each backend (the first ``kernel`` pass cold; a second one warm,
   without the four group-by and top-k statements whose host work
   dominates); every answer must equal the in-memory cell's and the
   oracle's.  The
   fused kernel is checked and timed on one reopened shard's operands.
   Then, on the sorted store: a ``ShardProcessPool`` of forked workers
   (the host path: ``auto`` answers, ``kernel`` raises ``ForkSafetyError``)
   and a thread pool on the kernel path; live ingest (65,536 appended rows
   in 16 batches, a delete of about 1% of the rows, a second reader that
   replays the WAL and answers the lighter statements, compaction), each
   step against NumPy over the live
   rows, with device memory before and after compaction; and
   ``optimize()`` on a copy of the unsorted store, sizes before and after.

   Serving, over a copy of the saved sorted store taken before live
   ingest: ``Dataset.open(dir, mmap=True, device="cuda").serve(
   backend="kernel")`` on its default shard pool (threads on the card)
   mounted over HTTP answers the statement set as JSON statements (cold,
   after ``/admin/invalidate``, warm with fresh result caches, cached) and
   as SQL, one batch and ``/stats``; ``auto`` under a forked
   ``ShardProcessPool`` (host ``ewah`` in its workers); a live
   pass (``/ingest``, ``/delete``, counts against NumPy) on another copy;
   then ``LocalCluster``: 3 spawned workers on the card (replication 2,
   ``kernel``) behind the coordinator, every statement before and after
   one worker is killed with SIGKILL (exact answers, failovers, nothing
   degraded), the worker restarted; and one in-process ``ShardWorker``
   behind a ``WorkerServer`` thread, whose launches count here.  Every
   answer must equal the in-memory cell's and the oracle's.

3. LM training with EWAH gradient compression, ``block_sqnorms``:

    python -m repro_torch.launch.train --arch qwen2-0.5b --full \
        --compress 0.25 --steps 5 --batch-size 8 --seq-len 128

   qwen2-0.5b at full width and depth (494M parameters, weights from a
   seed, the synthetic bitmap-indexed corpus).  Every loss must be finite,
   the supervisor must not have restarted, and the kernel must have run
   once per step.  Then: one step under the profiler (device idle share),
   the keep mask from the kernel's norms against the plain norms' on one
   full-width gradient, and a restart on the card (reduced config,
   checkpoint every 2 steps, a failure injected at step 3) whose losses
   must match an uninterrupted run.

4. LM serving, batched greedy prefill and decode (no kernel of the port
   lies on this path; every count must stay 0):

    python -m repro_torch.launch.serve --arch <arch> --full \
        --batch 4 --prompt-len 16 --new-tokens 32 --device cuda

   for qwen2-0.5b (dense), mamba2-780m (ssm), zamba2-1.2b (hybrid) and
   whisper-small (encoder-decoder, 1,500 seeded frames) at full width and
   depth, then arctic-480b (moe: d_model 7168, 128 experts top-2, dense
   residual) at full width with 1 of its 35 layers, through
   ``repro_torch.serve.loop.generate`` twice.  Weights from seed 0.  Every
   served token must lie in [0, vocab) and the teacher-forced
   ``serve_step`` logits over the prompt must be finite; for the four,
   in float32 compute, they must equal ``LM.forward``'s within rtol = atol
   = 0.15 (the reference's decode-vs-forward tolerance; the bfloat16
   comparison is printed: at depth bfloat16 rounding takes the two paths
   apart in the reference too); arctic's two runs must give the same
   tokens.  One qwen2-0.5b decode step runs under the profiler
   (device idle share, launches per token).

5. The dry-run tooling (``repro_torch.launch.{dryrun,sweep,op_analysis}``):
   (a) ``python -m repro_torch.launch.sweep --mesh both`` on ``meta``, one
   process an arch, all started together: 10 archs x 4 shapes x 2 meshes,
   no ``error`` cell, ``skipped`` exactly where ``shape_applicable``
   skips; (b) three real steps at full width, each traced on ``meta``
   first and then run on the card under the op counter: one
   ``serve_step`` of qwen2-0.5b and one of mamba2-780m at decode_32k
   (batch 128, a 32,768-position cache: 51.5 GB for qwen2-0.5b), and one
   compressed training step of the qwen2-0.5b cell above (whose
   ``block_sqnorms`` launch the counter costs as a custom call).  The
   counted FLOPs and bytes on the card must equal the meta trace's, the
   counted matmul FLOPs over the device busy time (``torch.profiler``)
   must not exceed 989 TFLOP/s x 1.05, and the meta trace's peak must lie
   within 25% of ``max_memory_allocated``; step time (CUDA events),
   achieved rates, roofline share and idle share are printed.  (c) The
   compressed cell for 3 steps under remat ``full``, ``dots_nb`` and
   ``none``: the losses agree within rtol 1e-3.

Each kernel's launch counter is set to 0 just before a main-path run and
read just after it.  Prints the card's name and power limit, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result line, when CUDA is unavailable or the
port's sources are not beside it.  Imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
ROWS_SORTED = 1 << 22
ROWS_UNSORTED = 1 << 21
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, NVIDIA data sheet
TILE_BYTES = 8 * 1024 * 4     # one (8, 1024) tile of 32-bit words
NAMES = ["c0", "c1", "c2", "c3"]
REPS = 30
SPIN_CYCLES = 2_000_000       # about 1 ms at the H100's 1.98 GHz boost clock
QWEN2_PARAMS = 494_032_768    # qwen2-0.5b's parameter count: its flat gradient


def log(*parts):
    print(*parts, flush=True)


def release(torch):
    """Free what the last phase left: unreachable objects first (their
    device tensors with them), then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


# -- timing -------------------------------------------------------------------

class Timer:
    """Median device time of a call, by CUDA events around each call, with
    the 50 MB L2 cache flushed before each one: the executor finds its
    cached operands in device memory, not in L2.  The flush reads 256 MB,
    so it leaves L2 holding clean lines (a flush that writes would leave
    up to 50 MB of dirty lines for the timed call to write back).  A spin
    of about 1 ms (``torch.cuda._sleep``) queued before the start event
    keeps the card busy while the host enqueues the call, so the events
    time the call's device work and not its host code.  ``floor_ms`` is
    what the same method gives an empty kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(64 << 20, dtype=torch.float32,
                                 device="cuda")
        self.floor_ms = self.ms(lambda: torch.cuda._sleep(1))

    def ms(self, fn, reps: int = REPS, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.sum()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def tile_reads(wl, flags_a, flags_b, op: str) -> int:
    """Operand tiles ``word_logical`` must read for these flags: a dirty
    tile, unless the other side's clean constant fixes the result alone
    (the rule of ``csrc/word_logical.cu``).  Sizes the kernel's bytes
    bound."""
    def decides(f, left):
        if op == "and":
            return f == wl.CLEAN0
        if op == "or":
            return f == wl.CLEAN1
        if op == "xor":
            return f != f
        return f == (wl.CLEAN0 if left else wl.CLEAN1)  # a & ~b
    read_a = (flags_a == wl.DIRTY) & ~decides(flags_b, False)
    read_b = (flags_b == wl.DIRTY) & ~decides(flags_a, True)
    return int(read_a.sum()) + int(read_b.sum())


# -- kernel phase ---------------------------------------------------------------

def word_logical_case(torch, wl, timer, a, b, op, label, fa=None,
                      fb=None):
    """Check one word_logical launch against the plain version on the
    card and time kernel, plain version and the library call.  Flags
    default to the exact tile flags of the words."""
    if fa is None:
        fa, fb = wl.tile_flags(a), wl.tile_flags(b)
    got = wl.word_logical(a, b, fa, fb, op)
    torch.cuda.synchronize()
    want = wl.word_logical_plain(a, b, fa, fb, op)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"word_logical {op} {label}: kernel != plain "
                             f"(max abs err {err})")
    lib = {"and": torch.bitwise_and, "or": torch.bitwise_or,
           "xor": torch.bitwise_xor}.get(op)
    if lib is not None and not torch.equal(lib(a, b), got):
        raise AssertionError(f"word_logical {op} {label}: != torch.{lib}")
    R, C = a.shape
    n_bytes = (tile_reads(wl, fa, fb, op) * TILE_BYTES + R * C * 4
               + 2 * fa.numel() * 4)
    row = {
        "shape": [R, C], "op": op, "label": label,
        "max_abs_err": err,
        "ms": timer.ms(lambda: wl.word_logical(a, b, fa, fb, op)),
        "plain_ms": timer.ms(
            lambda: wl.word_logical_plain(a, b, fa, fb, op), reps=5),
        "bound_ms": bound_ms(n_bytes), "bound_by": "bytes",
        "library_ms": timer.ms(lambda: lib(a, b)) if lib else None,
        "dirty_tiles": [int((fa == wl.DIRTY).sum()),
                        int((fb == wl.DIRTY).sum()), int(fa.numel())],
    }
    log("kernel_case", json.dumps(row))
    return row


def synthetic_words(torch, gen, R, C):
    """Random words with forced clean-0 / clean-1 tiles and top bits set."""
    a = torch.randint(-2**31, 2**31 - 1, (R, C), dtype=torch.int32,
                      device="cuda", generator=gen)
    b = torch.randint(-2**31, 2**31 - 1, (R, C), dtype=torch.int32,
                      device="cuda", generator=gen)
    a[:, : C // 4] = 0                 # a: first quarter clean-0
    b[:, C // 4: C // 2] = -1          # b: second quarter clean-1
    a[: R // 2, C // 2: 3 * C // 4] = -1
    b[R // 2:, 3 * C // 4:] = 0
    return a, b


def kernel_phase(torch, ops, wl, lr, timer):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    words_sorted = ops.bucket_cols(-(-ROWS_SORTED // 32))
    words_unsorted = ops.bucket_cols(-(-ROWS_UNSORTED // 32))
    # the pairwise kernel at the shapes of its launches on the main path
    # before the fused reduction: the halves of a 64-row bucketed stack,
    # and the one-row AND-NOT padded to a tile of 8 rows
    for R, C in ((32, words_sorted), (8, words_sorted), (8, words_unsorted)):
        a, b = synthetic_words(torch, gen, R, C)
        for op in wl.OPS:
            word_logical_case(torch, wl, timer, a, b, op, "synthetic")
    # the fused reduction over synthetic rows: the sorted table's width
    # with clean blocks, and a dense 100-row stack at the unsorted width
    for L, C, dense in ((2, words_sorted, False), (3, words_sorted, False),
                        (8, words_sorted, False), (64, words_sorted, False),
                        (100, words_unsorted, True)):
        m = torch.randint(-2**31, 2**31 - 1, (L, C), dtype=torch.int32,
                          device="cuda", generator=gen)
        if not dense:
            m[0, : C // 3] = 0
            m[-1, C // 2:] = -1
        rf = torch.from_numpy(ops.np_row_flags(
            m.cpu().numpy().view(np.uint32))).cuda()
        rows, flags = list(m.unbind(0)), list(rf.unbind(0))
        for op in ("and", "or", "xor"):
            reduce_case(torch, ops, lr, timer, rows, flags, [], [], op,
                        f"synthetic L={L}",
                        whole=lambda: ops.logical_reduce(m, op, row_flags=rf))


def reduce_bytes(torch, lr, flags, n_pos: int, op: str, cols: int) -> int:
    """Least bytes of one fused reduction: the DIRTY row blocks that the
    result needs (none in a flag column that an absorbing flag decides:
    CLEAN0 of a pos row under and, CLEAN1 under or, CLEAN1 of a neg row),
    read once; every flag read once; the result row and its flag row
    written once.  ``flags`` holds each row's flag row, or None for a row
    read whole.  Sizes the kernel's bytes bound by the rule of
    ``csrc/logical_reduce.cu``."""
    nfc = lr.n_flag_cols(cols)
    f = torch.stack([torch.full((nfc,), lr.DIRTY, dtype=torch.int32)
                     if x is None else x[:nfc].cpu() for x in flags])
    pos, neg = f[:n_pos], f[n_pos:]
    pos_absorbs = {"and": (pos == lr.CLEAN0).any(0),
                   "or": (pos == lr.CLEAN1).any(0)}.get(
                       op, torch.zeros(nfc, dtype=torch.bool))
    zero = (neg == lr.CLEAN1).any(0)
    if op == "and":
        zero |= pos_absorbs
    width = torch.full((nfc,), lr.FLAG_COLS, dtype=torch.int64)
    width[-1] = cols - (nfc - 1) * lr.FLAG_COLS
    read_pos = ((pos == lr.DIRTY) & ~(pos_absorbs | zero)).sum(0)
    read_neg = ((neg == lr.DIRTY) & ~zero).sum(0)
    words_read = int(((read_pos + read_neg) * width).sum())
    n_flags = sum(nfc for x in flags if x is not None)
    return 4 * (words_read + n_flags + cols + nfc)


def host_ms(torch, timer, fn, reps: int = REPS) -> float:
    """Median host-clock time of a call that ends in a synchronize, the L2
    flushed before each: the whole call, host code and launches included."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        timer.flush.sum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def reduce_case(torch, ops, lr, timer, pos, pos_flags, neg, neg_flags, op,
                label, whole=None):
    """Check one fused reduction against its plain version on the card
    (words and flag row) and against a fold of the raw rows, then time the
    kernel alone (``ms``, CUDA events), the whole ``ops`` call
    (``call_ms``, host clock: ``whole``, by default the executor's list
    form) and the plain version, beside the bytes bound.  ``library_ms``
    is null: no single PyTorch call folds rows."""
    rows, flags = list(pos) + list(neg), list(pos_flags) + list(neg_flags)
    n_launch = -(-len(rows) // lr.MAX_ROWS)
    before = lr.launches
    got, got_flags = lr.fold(pos, pos_flags, neg, neg_flags, op)
    torch.cuda.synchronize()
    if lr.launches - before != n_launch:
        raise AssertionError(f"logical_reduce {label}: "
                             f"{lr.launches - before} launches, expected "
                             f"{n_launch}")
    want, want_flags = lr.fold_plain(rows, flags, len(pos), op)
    err = exact_err(torch, got, want)
    fold_op = {"and": torch.bitwise_and, "or": torch.bitwise_or,
               "xor": torch.bitwise_xor}[op]
    raw = functools.reduce(fold_op, pos)
    if neg:
        raw = raw & ~functools.reduce(torch.bitwise_or, neg)
    if not (torch.equal(got, want) and torch.equal(got, raw)
            and torch.equal(got_flags, want_flags)):
        raise AssertionError(f"logical_reduce {op} {label}: kernel != plain "
                             f"(max abs err {err})")
    if whole is None:
        whole = (lambda: ops.diff_reduce(pos, pos_flags, neg, neg_flags)) \
            if neg else (lambda: ops.logical_reduce(pos, op,
                                                    row_flags=pos_flags))
    cols = got.numel()
    nfc = lr.n_flag_cols(cols)
    row = {
        "label": label, "op": op, "rows": [len(pos), len(neg)],
        "cols": cols, "launches": n_launch, "max_abs_err": err,
        "ms": timer.ms(lambda: lr.fold(pos, pos_flags, neg, neg_flags, op)),
        "call_ms": host_ms(torch, timer, whole),
        "plain_ms": timer.ms(lambda: lr.fold_plain(rows, flags, len(pos),
                                                   op), reps=5),
        "bound_ms": bound_ms(reduce_bytes(torch, lr, flags, len(pos), op,
                                          cols)),
        "bound_by": "bytes", "library_ms": None,
        "dirty_blocks": [sum(nfc if f is None else
                             int((f[:nfc] == lr.DIRTY).sum())
                             for f in flags), len(flags) * nfc],
    }
    log("reduce_case", json.dumps(row))
    return row


# -- main path ----------------------------------------------------------------

def make_table(synth, n, seed):
    rng = np.random.default_rng(seed)
    table, _ = synth.factorize(synth.uniform_table(n, 4, r=2, rng=rng))
    sales = rng.integers(0, 1_000_000, n)
    return table, {"sales": sales}


def statements(col, table, cards=None):
    """The statement set as (name, filter expression, terminal), with the
    NumPy masks of its two filters over ``table``.  ``cards`` (default:
    those of ``table``) picks the filters' values."""
    cards = table.max(axis=0) + 1 if cards is None else np.asarray(cards)
    by_card = [int(c) for c in np.argsort(cards)]   # narrowest first
    narrow, wide = by_card[0], by_card[-1]
    second = by_card[-2]
    rng = np.random.default_rng(SEED + 1)
    vals = sorted(int(v) for v in rng.choice(int(cards[wide]), 40,
                                             replace=False))
    vals2 = sorted(int(v) for v in rng.choice(int(cards[second]), 100,
                                              replace=False))
    v_narrow = int(rng.integers(0, int(cards[narrow])))
    mid = [c for c in range(4) if c not in (wide, narrow)]
    e_in = col(NAMES[wide]).isin(vals)
    # AND of two ORs minus one bitmap: on the unsorted table the two OR
    # results are dense, so ``auto`` takes the kernel for the AND-NOT
    e_diff = e_in & col(NAMES[second]).isin(vals2) \
        & ~(col(NAMES[narrow]) == v_narrow)
    masks = {
        "in": np.isin(table[:, wide], vals),
        "andnot": np.isin(table[:, wide], vals)
        & np.isin(table[:, second], vals2)
        & (table[:, narrow] != v_narrow),
    }
    exprs = {"in": e_in, "andnot": e_diff}
    g1, g2 = NAMES[mid[0]], NAMES[mid[1]]
    out = []
    for name, e in exprs.items():
        out += [
            (f"{name}.count", e, lambda q: q.count()),
            (f"{name}.group_by", e, lambda q: q.group_by(g1).count()),
            (f"{name}.top_k", e, lambda q: q.top_k(g2, 10)),
            (f"{name}.top_k_sales", e, lambda q: q.top_k(g1, 10, "sales")),
            (f"{name}.sum", e, lambda q: q.sum("sales")),
            (f"{name}.avg", e, lambda q: q.avg("sales")),
            (f"{name}.min", e, lambda q: q.min("sales")),
            (f"{name}.max", e, lambda q: q.max("sales")),
            (f"{name}.group2_sum", e,
             lambda q: q.group_by(g1, g2).sum("sales")),
            (f"{name}.rows100", e, lambda q: q.rows(limit=100)),
        ]
    return out, masks, (mid[0], mid[1])


def oracle_check(results, masks, table, sales, groups):
    """The answers against NumPy over the same (sorted) rows."""
    ga, gb = groups
    ca, cb = (int(table[:, c].max()) + 1 for c in groups)
    for name, mask in masks.items():
        s = sales[mask]
        want = {
            "count": int(mask.sum()),
            "group_by": np.bincount(table[mask, ga], minlength=ca),
            "sum": int(s.sum()),
            "min": int(s.min()), "max": int(s.max()),
            "avg": int(s.sum()) / int(mask.sum()),
            "rows100": np.flatnonzero(mask)[:100],
        }
        g2 = np.zeros(ca * cb, dtype=np.int64)
        np.add.at(g2, table[mask, ga] * cb + table[mask, gb], s)
        want["group2_sum"] = g2.reshape(ca, cb)
        for term, w in want.items():
            got = results[f"{name}.{term}"]
            if not np.array_equal(np.asarray(got), np.asarray(w)):
                raise AssertionError(f"{name}.{term}: {got!r} != oracle")
        top = results[f"{name}.top_k"]
        counts = np.bincount(table[mask, gb], minlength=cb)
        if [c for _, c in top] != sorted(counts, reverse=True)[:10]:
            raise AssertionError(f"{name}.top_k does not match the oracle")


def same(x, y) -> bool:
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and \
            np.array_equal(x, y)
    return type(x) is type(y) and x == y


def check_same(label, got, want, skip=()):
    """Every statement of ``got`` (a run of the whole set or of part of
    it), ``skip`` aside, must equal its answer in ``want``."""
    bad = [k for k in got if k not in skip and not same(got[k], want[k])]
    if bad:
        raise AssertionError(f"{label}: differs on {bad}")


def run_backend(ds, stmts, backend, torch, wl, lr):
    """Drive every statement once under ``backend``; returns results,
    per-statement host seconds and the launches of this run, of the fused
    ``logical_reduce`` and of the pairwise ``word_logical``."""
    wl.launches = 0
    lr.launches = 0
    results, secs = {}, {}
    t0 = time.perf_counter()
    for name, e, term in stmts:
        s = time.perf_counter()
        results[name] = term(ds.query(backend=backend).where(e))
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - s
    total = time.perf_counter() - t0
    launches = {"logical_reduce": lr.launches, "word_logical": wl.launches}
    return results, secs, total, launches


def main_path(label, n_rows, sort, torch, wl, lr, synth, Dataset, col,
              must_launch):
    table, measures = make_table(synth, n_rows, SEED)
    t0 = time.perf_counter()
    ds = Dataset.from_rows(table, NAMES, sort=sort, measures=measures,
                           device="cuda")
    build_s = time.perf_counter() - t0
    log(f"{label}: rows={n_rows} sort={sort} bitmaps={ds.index.n_bitmaps} "
        f"size_words={ds.size_words} build_s={build_s}")
    rows = ds.table
    sales = ds.index.measure("sales")
    stmts, masks, groups = statements(col, rows)
    runs = {}
    for backend in ("ewah", "kernel", "auto", "kernel"):
        # the second "kernel" pass finds every operand cached on the card
        key = backend if backend not in runs else backend + "_warm"
        runs[key] = run_backend(ds, stmts, backend, torch, wl, lr)
        res, secs, total, launches = runs[key]
        log(f"{label} backend={key}: launches={launches} total_s={total} "
            + json.dumps(secs))
    base = runs["ewah"][0]
    for key, (res, _, _, _) in runs.items():
        check_same(f"{label}: backend {key} against ewah", res, base)
    oracle_check(base, masks, rows, sales, groups)
    if any(runs["ewah"][3].values()):
        raise AssertionError(f"{label}: ewah backend launched a kernel: "
                             f"{runs['ewah'][3]}")
    for key in must_launch:
        if runs[key][3]["logical_reduce"] <= 0:
            raise AssertionError(f"{label}: backend {key} never launched "
                                 f"logical_reduce")
    # the host re-compression every kernel-path node ends in
    from repro_torch.core.ewah import EWAH
    e = next(e for name, e, _ in stmts if name == "andnot.count")
    words = ds.query(backend="ewah").where(e).bitmap().to_words()
    t0 = time.perf_counter()
    EWAH.from_words(words, ds.n_rows)
    log(f"{label}: host EWAH.from_words of the andnot result "
        f"({len(words)} words) s={time.perf_counter() - t0}")
    cache = ds.index.dense_cache
    cache_bytes = sum(w.nbytes + f.nbytes for w, f in cache.values())
    log(f"{label}: dense operand cache entries={len(cache)} "
        f"bytes={cache_bytes} cuda_allocated={torch.cuda.memory_allocated()}")
    log(f"{label}: oracle ok; backends agree")
    return ds, stmts, {k: v[3] for k, v in runs.items()}, runs["ewah"][0]


def record_reductions(lr, ds, stmts, name="andnot.count"):
    """The fused reductions of one statement under the kernel backend, as
    the executor hands them to ``logical_reduce.fold``: (pos, pos flags,
    neg, neg flags, op) each, holding the operand tensors."""
    seen = []
    real = lr.fold

    def record(pos, pos_flags, neg=(), neg_flags=(), op="and"):
        seen.append((list(pos), list(pos_flags), list(neg), list(neg_flags),
                     op))
        return real(pos, pos_flags, neg, neg_flags, op)

    e = next(e for n, e, _ in stmts if n == name)
    lr.fold = record
    try:
        ds.query(backend="kernel").where(e).count()
    finally:
        lr.fold = real
    return seen


def main_path_case(torch, ops, lr, timer, ds, stmts, label):
    """The fused kernel on the main path's own operands: each reduction of
    the AND-NOT statement under the kernel backend (the 40-value OR, the
    100-value OR and the AND-NOT node), checked and timed by
    ``reduce_case``.  Returns their rows."""
    rows = []
    for pos, pf, neg, nf, op in record_reductions(lr, ds, stmts):
        kind = "and-not" if neg else f"{len(pos)}-value {op}"
        rows.append(reduce_case(torch, ops, lr, timer, pos, pf, neg, nf, op,
                                f"main_path {label} {kind}"))
    return rows


def profile_statements(torch, ds, stmts, backend, prefix):
    """Device busy time of one statement group under the profiler: the
    sum of device time over all kernels against the wall clock."""
    from torch.profiler import ProfilerActivity, profile
    chosen = [(n, e, t) for n, e, t in stmts if n.startswith(prefix)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, e, term in chosen:
            term(ds.query(backend=backend).where(e))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only: an operator's row repeats its kernels' time
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(ev.self_device_time_total for ev in events)
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:8]
    log(f"profile backend={backend} statements={prefix}*: "
        + json.dumps({
            "wall_s": wall_s, "device_busy_s": device_us / 1e6,
            "device_idle_share": 1 - device_us / 1e6 / wall_s,
            "top_device": [[ev.key, ev.count, ev.self_device_time_total]
                           for ev in top]}))


# -- index-profile phase: bitpack, popcount_rows, popcount_total -----------------

def index_bits(torch, ds, device):
    """(n_rows, n_bitmaps) bools of the index's rows, in index order: each
    column's k-of-N codes scattered at its bitmaps' offset, the same
    scatter as the builder's (``core/index.py``, ``_close_partition``)."""
    table = ds.table
    n, n_bitmaps = len(table), ds.index.n_bitmaps
    bits = torch.zeros((n, n_bitmaps), dtype=torch.bool, device=device)
    flat = bits.view(-1)
    row_base = torch.arange(n, dtype=torch.int64,
                            device=device)[:, None] * n_bitmaps
    off = 0
    for c, ci in enumerate(ds.index.columns):
        codes = torch.from_numpy(
            ci.encoder.codes(table[:, c]).astype(np.int64)).to(device)
        flat[(row_base + (codes + off)).reshape(-1)] = True
        off += ci.encoder.L
    return bits


def index_words(ds) -> np.ndarray:
    """(n_bitmaps, n_words) uint32 words of every bitmap of the index, on
    the host, column by column."""
    cols = ds.index.columns
    out = np.empty((ds.index.n_bitmaps, -(-ds.n_rows // 32)), np.uint32)
    i = 0
    for c, ci in enumerate(cols):
        for b in range(ci.encoder.L):
            out[i] = ds.index.bitmap(c, b).to_words()
            i += 1
    return out


def exact_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def index_profile_run(torch, ops, pc, bp, ds, device):
    """The three kernels' main path over ``ds``'s index, through ``ops``:
    ``bitpack`` of its rows' bools (the bitmap build's inner loop), then
    ``popcount_rows`` (each bitmap's count, the planner's selectivity) and
    ``popcount_total`` of its bitmaps' words.  The launch counters are set
    to 0 just before and read just after.  Then each result is held
    against the index (its words, its ``bitmap_count``s, k bits a row in
    each column) and against the plain version.  Returns
    (bits, words, launches, max abs errors)."""
    bits = index_bits(torch, ds, device)
    host_words = index_words(ds)
    counts = torch.tensor([ci.bitmap_count(b) for ci in ds.index.columns
                           for b in range(ci.encoder.L)], dtype=torch.int32)
    want_total = sum(ci.encoder.k for ci in ds.index.columns) * ds.n_rows
    bp.launches = 0
    for name in pc.launches:
        pc.launches[name] = 0
    packed = ops.bitpack(bits)
    words = ops.to_device_words(host_words, device)
    rows = ops.popcount_rows(words)
    total = ops.popcount_total(words)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = {"bitpack": bp.launches, **pc.launches}
    del host_words
    errs = {"bitpack": exact_err(torch, packed, bp.bitpack_plain(bits)),
            "popcount_rows": exact_err(torch, rows,
                                       pc.popcount_rows_plain(words)),
            "popcount_total": exact_err(torch, total,
                                        pc.popcount_total_plain(words))}
    if any(errs.values()):
        raise AssertionError(f"index profile: kernel != plain: {errs}")
    if not torch.equal(packed.T, words):
        raise AssertionError("index profile: bitpack of the rows != the "
                             "index's bitmaps")
    if not torch.equal(rows.cpu(), counts):
        raise AssertionError("index profile: popcount_rows != bitmap_count")
    if int(total) != want_total:
        raise AssertionError(f"index profile: popcount_total {int(total)} "
                             f"!= {want_total}")
    return bits, words, launches, errs


def popcount_wrap_check(torch, ops, pc):
    """2^26 all-ones words hold 2^31 set bits: the reference's int32 sum
    wraps to -2^31, and so must kernel and plain version."""
    ones = torch.full((8, 1 << 23), -1, dtype=torch.int32, device="cuda")
    got = int(ops.popcount_total(ones))
    plain = int(pc.popcount_total_plain(ones))
    log(f"popcount_total wrap: 2^26 all-ones words -> kernel {got} "
        f"plain {plain}")
    if got != -2**31 or plain != -2**31:
        raise AssertionError(f"popcount_total wrap: kernel {got}, plain "
                             f"{plain}, expected {-2**31}")


def pairwise_case(torch, ops, wl, timer, words):
    """The pairwise ``ops.word_logical``, the reference's public API with no
    caller in the system since the executor folds n-ary nodes in one
    launch: the OR of the index's first 32 bitmaps with its next 32, with
    their own tile flags, as the executor's widest pairwise launch was.
    Its launch counter is set to 0 just before and read just after; then
    the kernel is checked and timed by ``word_logical_case``."""
    a, b = words[:32], words[32:64]
    wl.launches = 0
    got = ops.word_logical(a, b, "or")
    torch.cuda.synchronize()
    launches = wl.launches
    if launches != 1:
        raise AssertionError(f"index profile: word_logical made {launches} "
                             f"launches, expected 1")
    if not torch.equal(got, a | b):
        raise AssertionError("index profile: word_logical or != a | b")
    row = word_logical_case(torch, wl, timer, a, b, "or", "index_profile")
    row["launches"] = launches
    return row


def index_profile_phase(torch, ops, pc, bp, wl, timer, ds):
    """The index-profile main path on the sorted table's Dataset, the wrap
    check, the pairwise ``word_logical``, then each kernel timed at the
    main path's shape beside its bytes bound, its plain version and a
    ``torch.sum`` over the same bytes.  Returns each kernel's row of the
    kernels line."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bits, words, launches, errs = index_profile_run(torch, ops, pc, bp, ds,
                                                    "cuda")
    log(f"index profile: bits {tuple(bits.shape)} words "
        f"{tuple(words.shape)} launches={launches} errs={errs} "
        f"s={time.perf_counter() - t0}; bitpack == the index's bitmaps, "
        f"popcount_rows == bitmap_count, popcount_total == k x rows")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"index profile: {name} never launched")
    popcount_wrap_check(torch, ops, pc)
    out = {"word_logical": pairwise_case(torch, ops, wl, timer, words)}
    has_bitwise_count = hasattr(torch, "bitwise_count")
    library_note = ("no single PyTorch call computes it; torch."
                    f"bitwise_count present: {has_bitwise_count}")
    n, L = bits.shape
    R, C = words.shape
    cases = {
        "bitpack": (lambda: ops.bitpack(bits),
                    lambda: bp.bitpack_plain(bits), bits,
                    n * L + -(-n // 32) * L * 4, [n, L]),
        "popcount_rows": (lambda: ops.popcount_rows(words),
                          lambda: pc.popcount_rows_plain(words), words,
                          R * C * 4 + R * 4, [R, C]),
        "popcount_total": (lambda: ops.popcount_total(words),
                           lambda: pc.popcount_total_plain(words), words,
                           R * C * 4 + 4, [R, C]),
    }
    for name, (kernel, plain, x, n_bytes, shape) in cases.items():
        row = {"name": name, "shape": shape, "launches": launches[name],
               "max_abs_err": errs[name], "ms": timer.ms(kernel),
               "plain_ms": timer.ms(plain),
               "bound_ms": bound_ms(n_bytes), "bound_by": "bytes",
               "library_ms": None, "library_note": library_note,
               # a torch.sum over the same bytes read as float32 (torch's
               # integer sums are far slower): what a plain read of them
               # takes on this card, beside the bound
               "read_ms": timer.ms(lambda: x.view(torch.float32).sum())}
        log("index_case", json.dumps(row))
        out[name] = row
    log(f"index profile: peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    del bits, words
    torch.cuda.empty_cache()
    return out


# -- store-and-live phase: the index store, shards, WAL and live ingest -------

STORE_SHARDS = 4              # word-aligned row shards, all on the one card
APPEND_BATCHES = 16
APPEND_ROWS = 4096
POOL_WORKERS = 4
# the statements whose host interval work dominates the set's time; the
# store phase's repeat passes (warm, WAL replay) and the serving phase's
# (warm, the in-process worker) leave them out to keep the smoke well
# inside its time limit
HEAVY_TERMS = (".group_by", ".top_k", ".top_k_sales", ".group2_sum")
DEVICE = "cuda"               # the phase's device; its CPU test sets "cpu"


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def dense_cache_bytes(index) -> int:
    """Bytes of the dense operands cached on the card by every shard."""
    return sum(w.nbytes + f.nbytes for sh in index.shards
               for w, f in sh.dense_cache.values())


def store_cell(label, build, torch, wl, lr, Dataset, col, memory_results,
               root, must_launch):
    """Build the cell with ``STORE_SHARDS`` shards (``build()``), save it,
    reopen it from the memory-mapped files on the card, and drive the
    statement set under each backend: the first ``kernel`` pass after the
    open (cold: page-in, decode and upload of every operand), ``ewah``,
    ``auto``, and ``kernel`` again, without ``HEAVY_TERMS``, over the same
    shards with fresh result caches (warm: every operand already on the
    card).  Every pass must equal the
    in-memory cell's results and the NumPy oracle.  Returns the opened
    dataset, the statements, the oracle's rows and sales, the launches of
    each pass and the store directory."""
    from repro_torch.core import ShardedIndex
    t0 = time.perf_counter()
    built = build()
    build_s = time.perf_counter() - t0
    rows = built.table
    sales = np.concatenate([sh.measure("sales") for sh in built.index.shards])
    d = Path(root) / label
    t0 = time.perf_counter()
    built.save(str(d))
    save_s = time.perf_counter() - t0
    size_words = built.size_words
    del built
    t0 = time.perf_counter()
    ds = Dataset.open(str(d), mmap=True, device=DEVICE)
    open_s = time.perf_counter() - t0
    log(f"store {label}: rows={ds.n_rows} shards={ds.n_shards} "
        f"size_words={size_words} build_s={build_s} save_s={save_s} "
        f"disk_bytes={dir_bytes(d)} open_s={open_s}")
    stmts, masks, groups = statements(col, rows)
    light = [st for st in stmts if not st[0].endswith(HEAVY_TERMS)]
    warm = Dataset(ShardedIndex(ds.index.shards, column_names=NAMES),
                   device=DEVICE)
    runs = {}
    for key, target, backend, chosen in (
            ("kernel_cold", ds, "kernel", stmts), ("ewah", ds, "ewah", stmts),
            ("auto", ds, "auto", stmts),
            ("kernel_warm", warm, "kernel", light)):
        runs[key] = run_backend(target, chosen, backend, torch, wl, lr)
        res, secs, total, launches = runs[key]
        first = stmts[0][0]
        log(f"store {label} backend={key}: launches={launches} "
            f"total_s={total} first_statement={first} first_s={secs[first]} "
            f"dense_cache_bytes={dense_cache_bytes(ds.index)} "
            f"cuda_allocated={torch.cuda.memory_allocated()}")
        check_same(f"store {label} {key} against the in-memory cell", res,
                   memory_results)
    oracle_check(runs["ewah"][0], masks, rows, sales, groups)
    if any(runs["ewah"][3].values()):
        raise AssertionError(f"store {label}: ewah launched a kernel")
    for key in must_launch:
        if runs[key][3]["logical_reduce"] <= 0:
            raise AssertionError(f"store {label}: {key} never launched "
                                 f"logical_reduce")
    log(f"store {label}: oracle ok; every backend equals the in-memory cell")
    return ds, stmts, rows, sales, {k: v[3] for k, v in runs.items()}, d


def live_oracle(col, rows, cards, alive):
    """Masks of the statement set (its values picked by the base's
    ``cards``) over ``rows``, restricted to ``alive``."""
    _, masks, groups = statements(col, rows, cards)
    return {k: m & alive for k, m in masks.items()}, groups


def live_phase(torch, wl, lr, Dataset, col, d, rows, sales, stmts):
    """Live ingest on the reopened sorted store: appends with their sales
    values, a delete of about 1% of the rows, the statement set under
    ``kernel`` against NumPy over (base + appended) - deleted, a second
    reader that replays the WAL, compaction, and the statements again
    against NumPy over the compacted, re-sorted rows.  Returns the launches
    of its three statement passes."""
    ds = Dataset.open(str(d), live=True, device=DEVICE)
    live = ds.index
    rng = np.random.default_rng(SEED + 5)
    cards = rows.max(axis=0) + 1
    batches = [(np.stack([rng.integers(0, int(c), APPEND_ROWS)
                          for c in cards], axis=1),
                rng.integers(0, 1_000_000, APPEND_ROWS))
               for _ in range(APPEND_BATCHES)]
    t0 = time.perf_counter()
    for r, s in batches:
        live.append(r, measures={"sales": s})
    append_s = time.perf_counter() - t0
    n_app = APPEND_BATCHES * APPEND_ROWS
    narrow = int(np.argmin(cards))
    v_del = int(rng.integers(0, int(cards[narrow])))
    combined = np.concatenate([rows] + [r for r, _ in batches])
    sales_c = np.concatenate([sales] + [s for _, s in batches])
    alive = combined[:, narrow] != v_del
    t0 = time.perf_counter()
    removed = ds.delete(col(NAMES[narrow]) == v_del)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    stats = live.stats()
    log(f"live: appended {n_app} rows in {APPEND_BATCHES} batches "
        f"append_s={append_s} rows_per_s={n_app / append_s} "
        f"delete_s={delete_s} deleted={removed} "
        f"({removed / len(combined):.4%} of rows) "
        f"wal_bytes={stats['wal_bytes']} wal_frames={stats['wal_frames']}")
    if removed != int((~alive).sum()):
        raise AssertionError(f"live: delete removed {removed} rows, NumPy "
                             f"{int((~alive).sum())}")
    masks, groups = live_oracle(col, combined, cards, alive)
    out = {}
    res, _, total, out["live"] = run_backend(ds, stmts, "kernel", torch,
                                             wl, lr)
    oracle_check(res, masks, combined, sales_c, groups)
    log(f"live backend=kernel: launches={out['live']} total_s={total}; "
        f"oracle over (base + appended) - deleted ok")
    t0 = time.perf_counter()
    replayed = Dataset.open(str(d), device=DEVICE)
    replay_s = time.perf_counter() - t0
    light = [st for st in stmts if not st[0].endswith(HEAVY_TERMS)]
    r2, _, total2, out["replayed"] = run_backend(replayed, light, "kernel",
                                                 torch, wl, lr)
    check_same("live: the WAL replay", r2, res)
    log(f"live: second reader replayed the WAL: open_s={replay_s} "
        f"pending_rows={replayed.index.pending_rows} launches="
        f"{out['replayed']} total_s={total2}; equals the first reader")
    replayed.index.close()
    del replayed, r2
    gc.collect()
    cache_before = dense_cache_bytes(live.base)
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    info = ds.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    gc.collect()
    mem_after = torch.cuda.memory_allocated()
    log(f"live: compact_s={compact_s} info={json.dumps(info)} "
        f"disk_bytes={dir_bytes(d)} dense_cache_bytes before="
        f"{cache_before} after={dense_cache_bytes(live.base)} "
        f"cuda_allocated before={mem_before} after={mem_after}")
    if mem_before - mem_after < cache_before:
        raise AssertionError(f"live: compaction freed "
                             f"{mem_before - mem_after} bytes of the card, "
                             f"the old base cached {cache_before}")
    kept, kept_sales = combined[alive], sales_c[alive]
    order = ds.sort_order
    perm = np.lexsort(tuple(kept[:, c] for c in reversed(order)))
    kept, kept_sales = kept[perm], kept_sales[perm]
    masks, groups = live_oracle(col, kept, cards, np.ones(len(kept), bool))
    r3, _, total3, out["compacted"] = run_backend(ds, stmts, "kernel",
                                                  torch, wl, lr)
    oracle_check(r3, masks, kept, kept_sales, groups)
    check_same("live: compaction", r3, res, skip=("in.rows100",
                                                   "andnot.rows100"))
    log(f"live backend=kernel after compaction: launches="
        f"{out['compacted']} total_s={total3}; oracle over the re-sorted "
        f"live rows ok")
    for key, launches in out.items():
        if launches["logical_reduce"] <= 0:
            raise AssertionError(f"live: {key} never launched logical_reduce")
    ds.index.close()
    return out


def pool_phase(torch, wl, lr, index, stmts):
    """Shard pools on the reopened sorted store, after the parent launched
    kernels: forked workers (``ShardProcessPool``) answer the count
    statements under ``auto`` on the host as the parent does in process,
    and refuse an explicit ``kernel`` with ``ForkSafetyError``; a thread
    pool runs each shard's kernel path from its own thread and must equal
    the sequential run.  Returns the thread pool run's launches."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import ForkSafetyError, ShardedIndex
    from repro_torch.core.shard import ShardProcessPool
    exprs = {n: e for n, e, _ in stmts if n.endswith(".count")}

    def fresh():
        return ShardedIndex(index.shards, column_names=NAMES)

    want = {n: fresh().count(e, backend="auto", device=DEVICE)
            for n, e in exprs.items()}
    pool = ShardProcessPool(fresh(), workers=POOL_WORKERS)
    try:
        t0 = time.perf_counter()
        got = {n: pool.index.count(e, backend="auto", pool=pool)
               for n, e in exprs.items()}
        pool_s = time.perf_counter() - t0
        probes = pool.run_shards(("probe",), range(index.n_shards))
        try:
            pool.index.count(exprs["andnot.count"], backend="kernel",
                             pool=pool)
        except ForkSafetyError as exc:
            refused = str(exc)
        else:
            raise AssertionError("pool: backend=kernel in a forked worker "
                                 "did not raise ForkSafetyError")
    finally:
        pool.shutdown(wait=True)
    if got != want or {p["backend"] for p in probes} != {"ewah"}:
        raise AssertionError(f"pool: forked workers {got} {probes}, in "
                             f"process {want}")
    log(f"pool: ShardProcessPool({POOL_WORKERS}) counts under auto equal "
        f"the in-process ones {got} s={pool_s}; worker backends "
        f"{sorted({p['backend'] for p in probes})}; kernel refused: "
        f"{refused!r}")
    seq = fresh()
    want = {n: seq.count(e, backend="kernel", device=DEVICE)
            for n, e in exprs.items()}
    pooled = fresh()
    lr.launches = 0
    wl.launches = 0
    with ThreadPoolExecutor(POOL_WORKERS) as tp:
        t0 = time.perf_counter()
        got = {n: pooled.count(e, backend="kernel", pool=tp, device=DEVICE)
               for n, e in exprs.items()}
        torch.cuda.synchronize()
        thread_s = time.perf_counter() - t0
    launches = {"logical_reduce": lr.launches, "word_logical": wl.launches}
    if got != want or launches["logical_reduce"] <= 0:
        raise AssertionError(f"threads: {got} against {want}, launches "
                             f"{launches}")
    log(f"threads: ThreadPoolExecutor({POOL_WORKERS}) under kernel equals "
        f"the sequential run {got} s={thread_s} launches={launches}")
    return launches


def optimize_phase(torch, wl, lr, Dataset, d, stmts, memory_results, root):
    """``optimize()`` on a saved copy of the unsorted store: the advisor's
    sort and remaps re-lay it out, and every statement keeps its answer
    (``rows100`` aside: row ids move with the re-sort).  Prints the size
    before and after."""
    copy = Path(root) / "unsorted_optimized"
    shutil.copytree(d, copy)
    ds = Dataset.open(str(copy), device=DEVICE)
    disk_before = dir_bytes(copy)
    t0 = time.perf_counter()
    info = ds.optimize()
    optimize_s = time.perf_counter() - t0
    res, _, total, launches = run_backend(ds, stmts, "kernel", torch, wl, lr)
    check_same("optimize", res, memory_results,
               skip=("in.rows100", "andnot.rows100"))
    log(f"optimize: unsorted store re-laid out in {optimize_s} s: "
        f"size_words {info['size_words_before']} -> "
        f"{info['size_words_after']}, disk_bytes {disk_before} -> "
        f"{dir_bytes(copy)}, order={info['order']} remapped_columns="
        f"{info['remapped_columns']}; statements under kernel unchanged "
        f"(launches={launches} total_s={total})")
    return launches


def store_phase(torch, ops, wl, lr, timer, synth, Dataset, col,
                memory_results, sorted_memory, keep=None):
    """The whole store-and-live phase; returns its reduce rows and the
    launches of each of its main-path runs.  The sorted store's shards are
    cut by ``sorted_memory.shard(STORE_SHARDS)`` from the in-memory sorted
    cell (its retained sorted rows, re-indexed: the 2^22-row sort runs
    once in the smoke); the unsorted store is built by ``from_rows(...,
    shards=STORE_SHARDS)``.  ``keep``, a path, receives a copy of the saved
    sorted store's files before live ingest changes them (the serving
    phase serves it)."""
    launches = {}
    reduce_rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as root:
        ds, stmts, rows, sales, runs, d_sorted = store_cell(
            "sorted", lambda: sorted_memory.shard(STORE_SHARDS), torch, wl,
            lr, Dataset, col, memory_results["sorted"], root,
            must_launch=("kernel_cold", "kernel_warm"))
        launches.update({f"store_sorted_{k}": v for k, v in runs.items()})
        # the fused kernel on one reopened shard's own cached operands
        reduce_rows += main_path_case(
            torch, ops, lr, timer,
            Dataset(ds.index.shards[0], NAMES, device=DEVICE), stmts,
            "store sorted shard 0")
        launches["pool_threads"] = pool_phase(torch, wl, lr, ds.index, stmts)
        del ds
        if keep is not None:
            shutil.copytree(d_sorted, keep)
        release(torch)
        launches.update({f"live_{k}": v for k, v in live_phase(
            torch, wl, lr, Dataset, col, d_sorted, rows, sales,
            stmts).items()})
        del rows, sales
        release(torch)
        table, measures = make_table(synth, ROWS_UNSORTED, SEED)
        ds, stmts, _, _, runs, d_unsorted = store_cell(
            "unsorted", lambda: Dataset.from_rows(
                table, NAMES, sort="none", measures=measures,
                shards=STORE_SHARDS, device=DEVICE),
            torch, wl, lr, Dataset, col, memory_results["unsorted"], root,
            must_launch=("kernel_cold", "auto", "kernel_warm"))
        del table, measures
        launches.update({f"store_unsorted_{k}": v for k, v in runs.items()})
        del ds
        release(torch)
        launches["optimize"] = optimize_phase(
            torch, wl, lr, Dataset, d_unsorted, stmts,
            memory_results["unsorted"], root)
    log(f"store phase launches: {json.dumps(launches)}")
    return reduce_rows, launches


# -- serving phase: HTTP, the RPC wire, shard workers and the coordinator -----

SERVE_WORKERS = 3
SERVE_REPLICATION = 2
SERVE_DEADLINE_S = 120.0      # per shard task: covers a cold statement
SERVE_STARTUP_S = 180.0       # a worker's torch import and CUDA cold start
SERVE_MAX_ROWS = 100          # row answers are compared on their first 100
SERVE_INGEST_ROWS = 4096
# the statement answers of a response, by the statement set's terminal
ANSWER_KEYS = {"count": "count", "group_by": "counts", "top_k": "top",
               "top_k_sales": "top", "sum": "value", "avg": "value",
               "min": "value", "max": "value", "group2_sum": "values",
               "rows100": "rows"}


def http(base, path, payload=None):
    """POST ``payload`` (GET when None) to the service; the decoded JSON."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVE_DEADLINE_S) as resp:
        return json.loads(resp.read())


def wire_statements(stmts, groups, expr_to_json):
    """The statement set as the service's JSON bodies: (name, body)."""
    g1, g2 = (NAMES[c] for c in groups)
    select = {"count": {"count": True}, "group_by": {"group_count": g1},
              "top_k": {"top_k": {"col": g2, "k": 10}},
              "top_k_sales": {"top_k": {"col": g1, "k": 10,
                                        "measure": "sales"}},
              "sum": {"sum": "sales"}, "avg": {"avg": "sales"},
              "min": {"min": "sales"}, "max": {"max": "sales"},
              "group2_sum": {"sum": "sales", "by": [g1, g2]}}
    out = []
    for name, e, _ in stmts:
        term = name.split(".", 1)[1]
        where = expr_to_json(e)
        out.append((name, {"query": where} if term == "rows100"
                    else {"select": select[term], "where": where}))
    return out


def to_sql(w) -> str:
    """A wire filter as the SQL front door's WHERE text."""
    if w["op"] == "eq":
        return f"{w['col']} = {w['value']}"
    if w["op"] == "in":
        return f"{w['col']} IN ({', '.join(map(str, w['values']))})"
    if w["op"] == "not":
        return f"NOT ({to_sql(w['arg'])})"
    return "(" + f" {w['op'].upper()} ".join(to_sql(a) for a in w["args"]) \
        + ")"


def sql_statements(wire_stmts, groups):
    """The statements the SQL front door can say, as ``{"sql": ...}``
    bodies (all but the row queries)."""
    g1, g2 = (NAMES[c] for c in groups)
    head = {"count": ("count(*)", ""),
            "group_by": ("count(*)", f" GROUP BY {g1}"),
            "top_k": ("count(*)", f" GROUP BY {g2} LIMIT 10"),
            "top_k_sales": ("sum(sales)", f" GROUP BY {g1} LIMIT 10"),
            "sum": ("sum(sales)", ""), "avg": ("avg(sales)", ""),
            "min": ("min(sales)", ""), "max": ("max(sales)", ""),
            "group2_sum": ("sum(sales)", f" GROUP BY {g1}, {g2}")}
    out = []
    for name, body in wire_stmts:
        term = name.split(".", 1)[1]
        if term in head:
            fn, tail = head[term]
            out.append((name, {"sql": f"SELECT {fn} FROM t WHERE "
                                      f"{to_sql(body['where'])}{tail}"}))
    return out


def like(value, want):
    """A JSON answer in the type of the in-memory answer ``want``; the
    conversion must not change a value."""
    if isinstance(want, np.ndarray):
        return np.asarray(value, dtype=want.dtype)
    if isinstance(want, (list, tuple)):
        if not isinstance(value, list) or len(value) != len(want):
            return value
        return type(want)(like(v, w) for v, w in zip(value, want))
    got = type(want)(value)
    return got if got == value else value


def statement_pass(run, bodies, want):
    """Each body through ``run`` (a POST or a coordinator call): answers
    in the in-memory answers' types, seconds and responses by name."""
    results, secs, outs = {}, {}, {}
    for name, body in bodies:
        t0 = time.perf_counter()
        out = run(body)
        secs[name] = time.perf_counter() - t0
        term = name.split(".", 1)[1]
        value = out[ANSWER_KEYS[term]]
        if term == "rows100":
            value = value[:SERVE_MAX_ROWS]
        results[name], outs[name] = like(value, want[name]), out
    return results, secs, outs


def counted(torch, wl, lr, fn):
    """``fn()`` with both kernels' counts set to 0 just before it; its
    value and the launches it made."""
    wl.launches = 0
    lr.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"logical_reduce": lr.launches, "word_logical": wl.launches}


def gpu_memory():
    """The card's memory as ``nvidia-smi`` reports it: MiB used by all
    processes, and ``pid -> used memory`` of the compute processes it
    lists (none where it cannot see them)."""
    def smi(query):
        return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip().splitlines()
    apps = {}
    for line in smi("--query-compute-apps=pid,used_memory"):
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return smi("--query-gpu=memory.used")[0], apps


def http_phase(torch, wl, lr, Dataset, d, bodies, sqls, want):
    """The served store over HTTP, kernel path, on the default shard pool
    of a service on the card (threads; on the CPU, where the default is a
    forked process pool, threads are asked for): every statement cold (first after the open), cached (a result-LRU hit), in
    its SQL form, again after ``/admin/invalidate`` (the service's result
    LRU is empty; the shards' own result LRUs answer) and warm (without
    ``HEAVY_TERMS``: a fresh ``ShardedIndex`` over the same shards swapped
    in, so every result is computed again with its operands already on
    the card); then one batch and ``/stats``.  Returns the cold answers
    and the launches of each pass."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import ShardedIndex
    from repro_torch.serve.query_api import serve_in_thread
    t0 = time.perf_counter()
    ds = Dataset.open(str(d), mmap=True, device=DEVICE)
    pool = {} if DEVICE == "cuda" else {"shard_processes": 0}
    svc = ds.serve(backend="kernel", max_rows=SERVE_MAX_ROWS, **pool)
    if not isinstance(svc._shard_pool, ThreadPoolExecutor):
        raise AssertionError(f"http: the shard pool is "
                             f"{type(svc._shard_pool).__name__}")
    srv, port = serve_in_thread(svc)
    open_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{port}"
    post = functools.partial(http, base, "/query")
    light = [(n, b) for n, b in bodies if not n.endswith(HEAVY_TERMS)]
    passes, launches = {}, {}
    try:
        for key, chosen in (("cold", bodies), ("cached", bodies),
                            ("sql", sqls), ("invalidated", bodies),
                            ("warm", light)):
            if key == "invalidated":
                http(base, "/admin/invalidate", {})
            if key == "warm":
                svc.set_index(ShardedIndex(svc.index.shards,
                                           column_names=NAMES))
            passes[key], launches[key] = counted(
                torch, wl, lr, lambda: statement_pass(post, chosen, want))
            res, secs, outs = passes[key]
            # avg, min and max reuse the cached (sum, count, min, max) of
            # the filter's sum statement; the SQL forms share the JSON
            # forms' entries, but for the group-by (a one-column count
            # matrix in SQL)
            hits = sorted(n for n, o in outs.items() if o["cached"])
            if hits != sorted(n for n in outs if key == "cached"
                              or n.endswith((".avg", ".min", ".max"))
                              or (key == "sql"
                                  and not n.endswith(".group_by"))):
                raise AssertionError(f"http {key}: cached answers {hits}")
            check_same(f"http {key} against the in-memory cell", res, want)
            log(f"http {key}: launches={launches[key]} total_s="
                f"{sum(secs.values())} " + json.dumps(secs))
        rows = [(n, b) for n, b in bodies if n.endswith(".rows100")]
        http(base, "/admin/invalidate", {})
        t0 = time.perf_counter()
        batch = http(base, "/query", {"queries": [b["query"]
                                                  for _, b in rows]})
        batch_s = time.perf_counter() - t0
        for (name, _), out in zip(rows, batch["results"]):
            if not same(like(out["rows"], want[name]), want[name]):
                raise AssertionError(f"http batch: {name} differs")
        stats = http(base, "/stats")
        log(f"http batch of {len(rows)} row queries s={batch_s}; stats: "
            f"n_rows={stats['n_rows']} n_shards={stats['n_shards']} "
            f"cache={json.dumps(stats['cache'])} open_s={open_s} "
            f"dense_cache_bytes={dense_cache_bytes(svc.index)} "
            f"cuda_allocated={torch.cuda.memory_allocated()}")
        for key in ("cold", "warm"):
            if launches[key]["logical_reduce"] <= 0:
                raise AssertionError(f"http {key}: the kernel pass never "
                                     f"launched logical_reduce")
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    return passes["cold"][0], {f"http_{k}": v for k, v in launches.items()}


def process_pool_phase(Dataset, d, bodies, want):
    """``auto`` on a served store under a forked ``ShardProcessPool`` (the
    default on the CPU; asked for on the card): its workers run the host
    path; the same answers."""
    from repro_torch.core.shard import ShardProcessPool
    svc = Dataset.open(str(d), mmap=True, device=DEVICE).serve(
        backend="auto", max_rows=SERVE_MAX_ROWS,
        shard_processes=os.cpu_count() or 2)
    try:
        if not isinstance(svc._shard_pool, ShardProcessPool):
            raise AssertionError(f"auto: the shard pool is "
                                 f"{type(svc._shard_pool).__name__}")
        t0 = time.perf_counter()
        res, _, _ = statement_pass(
            lambda b: svc.query(b["query"]) if "query" in b
            else svc.statement(b), bodies, want)
        pool_s = time.perf_counter() - t0
        check_same("auto under the default process pool", res, want)
        log(f"auto: ShardProcessPool({svc._shard_pool.workers}) answers "
            f"equal the in-memory cell, total_s={pool_s}")
    finally:
        svc._shard_pool.shutdown(wait=True)
        svc.close()


def live_serve_phase(torch, Dataset, col, d, root, rows, stmts):
    """A short live pass over HTTP on a copy of the served store:
    ``/ingest`` of rows with their sales, one ``/delete``, and the count
    statements against NumPy over (base + ingested) - deleted."""
    from repro_torch.core.expr import to_wire
    from repro_torch.serve.query_api import serve_in_thread
    copy = Path(root) / "served_live"
    shutil.copytree(d, copy)
    svc = Dataset.open(str(copy), mmap=True, device=DEVICE).serve(
        backend="kernel", shard_processes=0)
    srv, port = serve_in_thread(svc)
    base = f"http://127.0.0.1:{port}"
    try:
        rng = np.random.default_rng(SEED + 7)
        cards = rows.max(axis=0) + 1
        new = np.stack([rng.integers(0, int(c), SERVE_INGEST_ROWS)
                        for c in cards], axis=1)
        new_sales = rng.integers(0, 1_000_000, SERVE_INGEST_ROWS)
        t0 = time.perf_counter()
        out = http(base, "/ingest", {"rows": new.tolist(), "measures":
                                     {"sales": new_sales.tolist()}})
        ingest_s = time.perf_counter() - t0
        narrow = int(np.argmin(cards))
        v_del = int(rng.integers(0, int(cards[narrow])))
        t0 = time.perf_counter()
        gone = http(base, "/delete", {"where": to_wire(
            col(NAMES[narrow]) == v_del)})
        delete_s = time.perf_counter() - t0
        combined = np.concatenate([rows, new])
        alive = combined[:, narrow] != v_del
        if out["appended"] != SERVE_INGEST_ROWS or \
                gone["removed"] != int((~alive).sum()):
            raise AssertionError(f"live serve: {out} {gone}")
        masks, _ = live_oracle(col, combined, cards, alive)
        counts = {}
        for name, e, _ in stmts:
            if name.endswith(".count"):
                counts[name] = http(base, "/query", {
                    "select": {"count": True}, "where": to_wire(e)})["count"]
                want = int(masks[name.split(".")[0]].sum())
                if counts[name] != want:
                    raise AssertionError(f"live serve: {name} "
                                         f"{counts[name]} != NumPy {want}")
        log(f"live serve: /ingest of {SERVE_INGEST_ROWS} rows s={ingest_s}, "
            f"/delete of {gone['removed']} rows s={delete_s}; counts "
            f"{counts} equal NumPy")
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def coordinator_run(svc, bodies, want, label):
    """The statements through a coordinator: exact, complete answers equal
    to ``want``; per-statement seconds logged."""
    res, secs, outs = statement_pass(
        lambda b: svc.query(b["query"]) if "query" in b
        else svc.statement(b), bodies, want)
    bad = [n for n, o in outs.items() if not o["exact"]
           or o["missing_shards"]]
    if bad:
        raise AssertionError(f"{label}: inexact answers {bad}")
    check_same(f"{label} against the in-memory cell", res, want)
    log(f"{label}: total_s={sum(secs.values())} " + json.dumps(secs))


def cluster_phase(torch, wl, lr, d, root, bodies, want):
    """Spawned workers over the served store on the one card, the
    coordinator in this process: every statement with all workers, then
    again after one worker is killed with SIGKILL (replicas answer:
    failovers, no degraded statement), then the worker restarted.  Then
    one in-process ``ShardWorker`` behind a ``WorkerServer`` thread, whose
    launches count here.  The workers' logs go to ``root``.  Returns the
    in-process worker's launches."""
    from repro_torch.distributed.cluster import ClusterService, Policy
    from repro_torch.launch.cluster import LocalCluster
    from repro_torch.serve.worker_api import ShardWorker, WorkerServer
    policy = Policy(deadline_s=SERVE_DEADLINE_S)
    used_before, _ = gpu_memory()
    t0 = time.perf_counter()
    with LocalCluster(str(d), n_workers=SERVE_WORKERS,
                      replication=SERVE_REPLICATION, policy=policy,
                      backend="kernel", device=DEVICE, start_monitor=False,
                      log_dir=str(root), startup_timeout_s=SERVE_STARTUP_S
                      ) as cluster:
        start_s = time.perf_counter() - t0
        svc = cluster.service
        used, apps = gpu_memory()
        log(f"cluster: {SERVE_WORKERS} workers r={SERVE_REPLICATION} "
            f"placement={cluster.placement} start_s={start_s} ready_s="
            f"{cluster.ready_s}; card memory used before the workers "
            f"{used_before}, after their start {used}, by worker "
            f"{[apps.get(p.pid) for p in cluster.procs]}")
        coordinator_run(svc, bodies, want, "cluster all workers")
        used, apps = gpu_memory()
        log(f"cluster: card memory used after the statements {used}, by "
            f"worker {[apps.get(p.pid) for p in cluster.procs]}")
        svc.invalidate_cache()
        cluster.kill_worker(0)
        coordinator_run(svc, bodies, want, "cluster after SIGKILL of worker 0")
        counters = svc.stats()["counters"]
        log(f"cluster counters after the kill: {json.dumps(counters)}")
        if counters["failovers"] <= 0 or counters["degraded_queries"] != 0:
            raise AssertionError(f"cluster: after the kill {counters}")
        cluster.restart_worker(0)
        svc.probe_all()
        if not svc.stats()["workers"][0]["up"]:
            raise AssertionError("cluster: restarted worker 0 is not up")
        log(f"cluster: worker 0 restarted, ready_s={cluster.ready_s[0]}")
    srv = WorkerServer(ShardWorker(str(d), [], backend="kernel",
                                   device=DEVICE)).start()
    svc = ClusterService(str(d), [srv.address], replication=1,
                         policy=policy, backend="kernel",
                         max_rows=SERVE_MAX_ROWS)
    try:
        svc.start(monitor=False)
        light = [(n, b) for n, b in bodies if not n.endswith(HEAVY_TERMS)]
        _, launches = counted(torch, wl, lr, lambda: coordinator_run(
            svc, light, want, "in-process worker"))
    finally:
        svc.close()
        srv.stop()
    log(f"in-process worker: launches={launches}")
    if launches["logical_reduce"] <= 0:
        raise AssertionError("in-process worker never launched "
                             "logical_reduce")
    return launches


def serve_phase(torch, wl, lr, Dataset, col, d, rows, sales, want):
    """The serving phase over the saved sorted store at ``d`` (its rows and
    sales in store order; ``want``, the in-memory cell's answers): HTTP,
    a process pool, a live pass, the cluster.  Returns the
    launches of its main-path runs."""
    from repro_torch.serve.query_api import expr_to_json
    stmts, masks, groups = statements(col, rows)
    bodies = wire_statements(stmts, groups, expr_to_json)
    sqls = sql_statements(bodies, groups)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        res, launches = http_phase(torch, wl, lr, Dataset, d, bodies, sqls,
                                   want)
        oracle_check(res, masks, rows, sales, groups)
        release(torch)
        process_pool_phase(Dataset, d, bodies, want)
        live_serve_phase(torch, Dataset, col, d, root, rows, stmts)
        release(torch)
        # the coordinator drives workers that run with no result cached
        launches["worker"] = cluster_phase(torch, wl, lr, d, root, bodies,
                                           want)
    log(f"serve phase: total_s={time.perf_counter() - t0} launches="
        f"{json.dumps(launches)}")
    return launches


# -- block_sqnorms kernel phase -------------------------------------------------

def block_sqnorms_case(torch, gc, timer, g, label):
    """Check one block_sqnorms call against the plain version on the card
    (rtol 1e-5: float32 sums of 256 positive squares in another order) and
    time kernel, plain version and ``torch.linalg.vecdot``.  ``g`` is what
    the caller hands the wrapper; the wrapper casts and pads it."""
    n = g.numel()
    got = gc.block_sqnorms(g)
    torch.cuda.synchronize()
    gp = torch.nn.functional.pad(g.float(), (0, -n % gc.VALUES_PER_BLOCK))
    g2 = gp.view(-1, gc.VALUES_PER_BLOCK)
    want = gc.block_sqnorms_plain(gp)
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if not torch.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"block_sqnorms {label}: kernel != plain "
                             f"(max abs err {err}, max rel err {rel})")
    n_blocks = got.numel()
    row = {
        "n": n, "dtype": str(g.dtype), "blocks": n_blocks, "label": label,
        "max_abs_err": err, "max_rel_err": rel,
        "ms": timer.ms(lambda: gc.block_sqnorms(g)),
        "plain_ms": timer.ms(lambda: gc.block_sqnorms_plain(gp)),
        # each input value read once at its own width, each norm written
        "bound_ms": bound_ms(n * g.element_size() + n_blocks * 4),
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: torch.linalg.vecdot(g2, g2, dim=1)),
        # one torch.sum over the same float32 values: what a plain read of
        # these bytes takes on this card, beside the bound
        "read_ms": timer.ms(lambda: gp.sum()),
    }
    log("block_sqnorms_case", json.dumps(row))
    return row


def block_sqnorms_phase(torch, gc, timer, n_params):
    """The main path's shape (every parameter of qwen2-0.5b, padded to a
    block multiple as ``sparsify`` pads it) and small ragged shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n_main = -(-n_params // gc.VALUES_PER_BLOCK) * gc.VALUES_PER_BLOCK
    g = torch.randn(n_main, generator=gen, device="cuda")
    g[n_params:] = 0
    main_row = block_sqnorms_case(torch, gc, timer, g, "main_path")
    del g
    for n in (256, 25_600, 25_617):
        block_sqnorms_case(torch, gc, timer, torch.randn(
            n, generator=gen, device="cuda"), "small")
    block_sqnorms_case(torch, gc, timer, torch.randn(
        25_617, generator=gen, device="cuda").half(), "float16")
    torch.cuda.empty_cache()
    return main_row


# -- training path --------------------------------------------------------------

TRAIN_STEPS = 5
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--full", "--compress", "0.25",
              "--steps", str(TRAIN_STEPS), "--batch-size", "8",
              "--seq-len", "128", "--ckpt-every", "1000", "--device", "cuda"]


def training_path(torch, gc, wl, lr, ckpt_dir):
    """The slice's main run through ``repro_torch.launch.train``'s entry;
    returns (model, params, report, block_sqnorms launches)."""
    from repro_torch.launch import train as launch_train
    torch.cuda.reset_peak_memory_stats()
    gc.launches = 0
    wl.launches = 0
    lr.launches = 0
    t0 = time.perf_counter()
    model, params, report = launch_train.main(
        TRAIN_ARGS + ["--ckpt-dir", ckpt_dir])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = gc.launches
    bitmap_launches = {"logical_reduce": lr.launches,
                       "word_logical": wl.launches}
    n_params = sum(p.numel() for p in params.values())
    log("train: " + json.dumps({
        "arch": model.cfg.name, "params": n_params,
        "steps_run": report.steps_run, "restarts": report.restarts,
        "losses": report.losses, "step_s": report.step_times,
        "total_s": total_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "block_sqnorms_launches": launches,
        "bitmap_kernel_launches": bitmap_launches}))
    losses = np.asarray(report.losses)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: a loss is not finite: {report.losses}")
    if report.restarts != 0:
        raise AssertionError(f"train: the supervisor restarted "
                             f"{report.restarts} times")
    if report.steps_run != TRAIN_STEPS or launches != TRAIN_STEPS:
        raise AssertionError(f"train: {report.steps_run} steps, "
                             f"{launches} block_sqnorms launches; expected "
                             f"{TRAIN_STEPS} of each")
    log(f"train: loss first={report.losses[0]} last={report.losses[-1]}")
    return model, params, report, launches


def train_batch(torch, model, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return {"tokens": torch.randint(0, model.cfg.vocab, (8, 128),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32)}


def profile_train_step(torch, model, params):
    """Device busy time of one compressed training step at full width
    under the profiler, after one warm step outside it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import grad_compression as gcomp
    from repro_torch.train.loop import make_compressed_train_step
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    opt = AdamW(AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10))
    state = {"inner": opt.init(params), "error": gcomp.init_error(params)}
    step = make_compressed_train_step(model, opt, 0.25)
    batch = train_batch(torch, model, SEED + 2)
    params, state, loss = step(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        float(loss)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(ev.self_device_time_total for ev in events)
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:12]
    sq = [ev for ev in events if "block_sqnorms" in ev.key]
    log("profile train step: " + json.dumps({
        "wall_s": wall_s, "device_busy_s": device_us / 1e6,
        "device_idle_share": 1 - device_us / 1e6 / wall_s,
        "block_sqnorms_device_us": sum(ev.self_device_time_total
                                       for ev in sq),
        "kernel_launches": sum(ev.count for ev in events),
        "top_device": [[ev.key[:80], ev.count, ev.self_device_time_total]
                       for ev in top]}))
    del state


def mask_phase(torch, gc, model, params):
    """The keep mask from the kernel's norms against the mask from the
    plain norms on one full-width gradient: any difference may only fall
    on a block whose norm is within rtol 1e-5 of either threshold."""
    from repro_torch.distributed import grad_compression as gcomp
    from repro_torch.train.step import value_and_grad
    _, grads = value_and_grad(model, params, train_batch(torch, model,
                                                         SEED + 3))
    flat, _ = gcomp._flatten(grads)
    del grads
    fpad = torch.nn.functional.pad(flat, (0, -flat.numel() % 256))
    del flat
    norms_k = gc.block_sqnorms(fpad)
    norms_p = gc.block_sqnorms_plain(fpad)
    k = max(int(norms_k.numel() * 0.25), 1)
    th_k = torch.topk(norms_k, k).values[-1]
    th_p = torch.topk(norms_p, k).values[-1]
    mask_k, mask_p = norms_k >= th_k, norms_p >= th_p
    diff = mask_k != mask_p
    near = ((norms_p - th_p).abs() <= 1e-5 * th_p) \
        | ((norms_k - th_k).abs() <= 1e-5 * th_k)
    out = {"blocks": norms_k.numel(), "kept": int(mask_k.sum()),
           "differ": int(diff.sum()), "differ_off_threshold":
           int((diff & ~near).sum()), "near_threshold": int(near.sum()),
           "max_rel_err": float(((norms_k - norms_p).abs()
                                 / norms_p.clamp_min(1e-30)).max())}
    log("mask on one gradient: " + json.dumps(out))
    if out["differ_off_threshold"]:
        raise AssertionError(f"mask: {out['differ_off_threshold']} blocks "
                             f"differ away from the threshold")


def restart_phase(torch, ckpt_root):
    """Reduced qwen2-0.5b on the card: a failure injected at step 3 and a
    restore from the step-2 checkpoint replay the uninterrupted run's
    losses (rtol 1e-3: the embedding backward sums with atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BitmapDataPipeline, Corpus
    from repro_torch.models.transformer import LM
    from repro_torch.train.loop import TrainConfig, train
    cfg = get_config("qwen2-0.5b").reduced()
    corpus = Corpus.synthetic(n_docs=256, doc_len=64, vocab=cfg.vocab,
                              seed=SEED)
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    start = {k: v.detach().clone() for k, v in model.init(gen).items()}
    runs = {}
    for label, fail in (("uninterrupted", None), ("restarted", 3)):
        tcfg = TrainConfig(steps=6, batch_size=4, seq_len=64,
                           ckpt_dir=str(Path(ckpt_root) / label),
                           ckpt_every=2, grad_compression=0.25, lr=1e-3)
        _, runs[label] = train(model, tcfg,
                               BitmapDataPipeline(corpus, device="cuda"),
                               params=start, inject_failure_at=fail,
                               device="cuda")
    ref, rep = runs["uninterrupted"], runs["restarted"]
    want = ref.losses[:3] + ref.losses[2:]
    log("restart: " + json.dumps({"uninterrupted": ref.losses,
                                  "restarted": rep.losses,
                                  "restarts": rep.restarts}))
    if rep.restarts != 1 or ref.restarts != 0:
        raise AssertionError(f"restart: restarts {ref.restarts}, "
                             f"{rep.restarts}; expected 0, 1")
    if not np.allclose(rep.losses, want, rtol=1e-3, atol=0):
        raise AssertionError("restart: the replayed losses differ from the "
                             "uninterrupted run's")


# -- LM serving ------------------------------------------------------------------

LM_SERVE_ARCHS = ["qwen2-0.5b", "mamba2-780m", "zamba2-1.2b", "whisper-small"]
LM_BATCH, LM_PROMPT, LM_NEW = 4, 16, 32     # the reference launcher's defaults
LM_FULL = True                # published widths; its CPU test sets False
ARCTIC_LAYERS = 1             # of 35: two layers' float32 weights overflow 80 GB
LM_TOL = 0.15                 # the reference's decode-vs-forward rtol and atol


def teacher_forced(torch, model, prompts, frontend):
    """``serve_step`` logits over the prompt, one step a token, float32."""
    from repro_torch.models import decode as dec
    cache = dec.init_cache(model, *prompts.shape)
    tokens = torch.as_tensor(prompts, device=model.device)
    if model.cfg.enc_dec:
        cache["xk"], cache["xv"] = dec.encdec_prefill_cross(
            model, torch.as_tensor(frontend, device=model.device))
    steps = []
    for i in range(prompts.shape[1]):
        logits, cache = dec.serve_step(model, cache, tokens[:, i:i + 1])
        steps.append(logits.float())
    return torch.cat(steps, dim=1)


def forward_logits(torch, model, prompts, frontend):
    """``LM.forward``'s logits over the prompt (and frames), float32."""
    batch = {"tokens": torch.as_tensor(prompts, device=model.device)}
    if model.cfg.enc_dec:
        batch["frontend"] = torch.as_tensor(frontend, device=model.device)
    with torch.no_grad():
        return model(batch)[0].float()


def logits_gap(dec, full):
    err = (dec - full).abs()
    return {"max_abs_diff": float(err.max()),
            "outside_tol": int((err > LM_TOL + LM_TOL * full.abs()).sum())}


def lm_check(torch, model, out, prompts, frontend, forward: bool):
    """The served tokens lie in [0, vocab) and start with the prompt; the
    teacher-forced logits are finite.  With ``forward``: in float32
    compute they equal ``LM.forward``'s within the reference's rtol = atol
    = 0.15; in bfloat16 the same comparison is printed, with each path's
    distance from the float32 forward, and not gated: the reference's own
    bfloat16 decode and forward leave that tolerance at depth
    (``tests/test_torch_moe_ssm.py``, 96 reduced mamba2 layers).  Returns
    what was checked; raises on a failure."""
    from repro_torch.models import layers as L
    name, vocab = model.cfg.name, model.cfg.vocab
    if out.shape != (LM_BATCH, LM_PROMPT + LM_NEW):
        raise AssertionError(f"{name}: served shape {out.shape}")
    if not ((out >= 0) & (out < vocab)).all():
        raise AssertionError(f"{name}: a token outside [0, {vocab})")
    if not np.array_equal(out[:, :LM_PROMPT], prompts):
        raise AssertionError(f"{name}: the output does not start with the "
                             f"prompt")
    dec = teacher_forced(torch, model, prompts, frontend)
    check = {"tokens_in_vocab": True}
    if not forward:
        if not bool(torch.isfinite(dec).all()):
            raise AssertionError(f"{name}: a decode logit is not finite")
        check["logits_finite"] = True
        return check
    full = forward_logits(torch, model, prompts, frontend)
    compute = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        dec32 = teacher_forced(torch, model, prompts, frontend)
        full32 = forward_logits(torch, model, prompts, frontend)
    finally:
        L.COMPUTE_DTYPE = compute
    for label, t in (("decode", dec), ("forward", full),
                     ("float32 decode", dec32), ("float32 forward", full32)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: a {label} logit is not finite")
    check.update(logits_finite=True, float32=logits_gap(dec32, full32),
                 bfloat16=logits_gap(dec, full),
                 bfloat16_from_float32={
                     "decode": logits_gap(dec, full32)["max_abs_diff"],
                     "forward": logits_gap(full, full32)["max_abs_diff"]})
    if check["float32"]["outside_tol"]:
        raise AssertionError(
            f"{name}: {check['float32']['outside_tol']} float32 decode "
            f"logits differ from the forward's beyond rtol=atol={LM_TOL} "
            f"(max {check['float32']['max_abs_diff']})")
    return check


def profile_decode_step(torch, model, prompts):
    """One greedy decode step of ``generate`` (``serve_step``, argmax, the
    token's copy to the host) under the profiler, after the prompt and one
    warm step outside it: device busy time, idle share, launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode as dec
    from repro_torch.serve.loop import _greedy, prefill_into_cache
    cache = dec.init_cache(model, LM_BATCH, LM_PROMPT + 2)
    logits, cache = prefill_into_cache(
        model, cache, torch.as_tensor(prompts, device=model.device))
    tok = _greedy(logits)
    logits, cache = dec.serve_step(model, cache, tok)
    tok = _greedy(logits)
    tok.cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = dec.serve_step(model, cache, tok)
        _greedy(logits).cpu()
        wall_s = time.perf_counter() - t0
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(ev.self_device_time_total for ev in events) / 1e6
    launches = sum(ev.count for ev in events)
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:8]
    out = {"arch": model.cfg.name, "wall_s": wall_s,
           "device_busy_s": device_s, "device_idle_share": 1 - device_s / wall_s,
           "launches_per_step": launches,
           "launches_per_token": launches / LM_BATCH,
           "top_device": [[ev.key[:80], ev.count, ev.self_device_time_total]
                          for ev in top]}
    log("profile decode step: " + json.dumps(out))
    return out


def kernel_counts(kernels, reset=False):
    """Every kernel's launch count (``kernels`` are the modules ``wl``,
    ``lr``, ``gc``, ``pc``, ``bp``), after setting them to 0 if
    ``reset``."""
    wl, lr, gc, pc, bp = kernels
    if reset:
        wl.launches = lr.launches = gc.launches = bp.launches = 0
        pc.launches.update(popcount_total=0, popcount_rows=0)
    return {"logical_reduce": lr.launches, "word_logical": wl.launches,
            "block_sqnorms": gc.launches, **pc.launches,
            "bitpack": bp.launches}


def lm_line(report, reduced, peak, check):
    line = {k: report[k] for k in ("arch", "params", "layers", "prefill_s",
                                   "decode_s", "tok_s", "decode_tok_s")}
    line.update(reduced=reduced, max_memory_allocated=peak, check=check)
    log("lm serve: " + json.dumps(line))
    return line


def lm_serve_phase(torch, kernels):
    """Greedy serving of one model of each family at full width: four
    through ``repro_torch.launch.serve``'s entry point at full depth, and
    arctic-480b at 1 of its 35 layers through ``serve.loop.generate``.
    Every kernel's count is set to 0 before each model and read after it:
    the path runs none of the port's kernels.  Returns the models'
    lines."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import LM
    from repro_torch.serve.loop import generate
    cuda = DEVICE == "cuda"
    size = "--full" if LM_FULL else "--reduced"
    lines = []
    for arch in LM_SERVE_ARCHS:
        release(torch)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        kernel_counts(kernels, reset=True)
        model, out, report = launch_serve.main([
            "--arch", arch, size, "--device", DEVICE, "--batch",
            str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--new-tokens",
            str(LM_NEW)])
        launches = kernel_counts(kernels)
        peak = torch.cuda.max_memory_allocated() if cuda else None
        if any(launches.values()):
            raise AssertionError(f"{arch}: the serving path launched "
                                 f"{launches}")
        prompts, frontend = launch_serve.make_inputs(model.cfg, LM_BATCH,
                                                     LM_PROMPT)
        check = lm_check(torch, model, out, prompts, frontend, forward=True)
        lines.append(lm_line(report, [] if LM_FULL else ["reduced config"],
                             peak, check))
        if arch == "qwen2-0.5b" and cuda:
            lines[-1]["profile"] = profile_decode_step(torch, model, prompts)
        del model
    # arctic-480b: full width, depth cut to fit its float32 weights (14.07 B
    # parameters at one layer, 56.3 GB) and the bfloat16 copy of one expert
    # weight (8.9 GB) on the card; no forward check, since the forward's
    # capacity drops tokens that the drop-free decode keeps
    release(torch)
    cfg = get_config("arctic-480b")
    if not LM_FULL:
        cfg = cfg.reduced()
    cfg = replace(cfg, n_layers=ARCTIC_LAYERS)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernel_counts(kernels, reset=True)
    model = LM(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    n_params = sum(p.numel() for p in model.init(gen).values())
    prompts, frontend = launch_serve.make_inputs(cfg, LM_BATCH, LM_PROMPT)
    runs, timings = [], {}
    for _ in range(2):
        runs.append(generate(model, prompts, LM_NEW,
                             max_len=LM_PROMPT + LM_NEW + 1,
                             frontend=frontend, timings=timings))
    launches = kernel_counts(kernels)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if any(launches.values()):
        raise AssertionError(f"arctic: the serving path launched {launches}")
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("arctic: two generate calls gave different "
                             "tokens")
    check = lm_check(torch, model, runs[1], prompts, frontend, forward=False)
    check["two_runs_identical"] = True
    n = LM_BATCH * LM_NEW
    dt = timings["prefill_s"] + timings["decode_s"]
    report = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
              **timings, "tok_s": n / dt,
              "decode_tok_s": n / timings["decode_s"]}
    cuts = [f"n_layers 35 -> {ARCTIC_LAYERS}"]
    lines.append(lm_line(report, cuts + ([] if LM_FULL else
                                         ["reduced config"]), peak, check))
    del model
    release(torch)
    return lines


# -- dry-run tooling: the sweep on meta, checked against real steps --------------

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bfloat16, NVIDIA data sheet
DRYRUN_ARCHS = None           # all ten; its CPU test takes fewer
DRYRUN_FULL = True            # published widths; its CPU test sets False
DRYRUN_SWEEP_S = 600          # per sweep process
PEAK_TOL = 0.25               # predicted against measured peak
FLOPS_TOL = 1.05              # counted matmul FLOP/s over the peak rate
REMAT_STEPS = 3


def dryrun_sweep(out_dir):
    """``repro_torch.launch.sweep --mesh both`` on meta into ``out_dir``,
    one process an arch, all started together; every cell is ``ok`` or
    ``skipped`` exactly where ``shape_applicable`` skips it.  Prints one
    line an (arch, shape); returns the records by file name."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, \
        shape_applicable
    archs = DRYRUN_ARCHS or list(ARCHS)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--mesh", "both",
         "--out-dir", str(out_dir), "--only-arch", a], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in archs}
    failed = {}
    try:
        for a, p in procs.items():
            out, _ = p.communicate(timeout=DRYRUN_SWEEP_S)
            if p.returncode:
                failed[a] = out[-2000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    sweep_s = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"sweep processes failed: {failed}")
    recs, errors, wrong = {}, [], []
    for a in archs:
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            row = {}
            for m in ("single", "multi"):
                rec = json.loads((Path(out_dir) / f"{a}__{s}__{m}.json")
                                 .read_text())
                recs[(a, s, m)] = rec
                if rec["status"] == "error":
                    errors.append((a, s, m, rec["error"]))
                want = "ok" if shape_applicable(cfg, shape)[0] else "skipped"
                if rec["status"] != want:
                    wrong.append((a, s, m, rec["status"], want))
                row[m] = rec
            if row["single"]["status"] == "ok":
                g = row["single"]["ops"]["global"]
                log("dryrun cell: " + json.dumps({
                    "arch": a, "shape": s, "flops": g["flops"],
                    "matmul_flops": g["matmul_flops"], "bytes": g["bytes"],
                    "peak_gb": g["peak_bytes"] / 1e9,
                    "args_gib_single": row["single"]["memory_analysis"][
                        "argument_size_in_bytes"] / 2**30,
                    "args_gib_multi": row["multi"]["memory_analysis"][
                        "argument_size_in_bytes"] / 2**30}))
    n_ok = sum(r["status"] == "ok" for r in recs.values())
    log(f"dryrun sweep: sweep_s={sweep_s} cells={len(recs)} ok={n_ok} "
        f"skipped={len(recs) - n_ok - len(errors)} errors={len(errors)}")
    if errors or wrong:
        raise AssertionError(f"sweep: errors {errors}, wrong status {wrong}")
    return recs, sweep_s


def dryrun_cells():
    """The three real steps: (label, config, shape, compressed)."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    cells = [("qwen2-0.5b decode_32k", "qwen2-0.5b", "decode_32k", False),
             ("mamba2-780m decode_32k", "mamba2-780m", "decode_32k", False),
             ("qwen2-0.5b compressed train 8x128", "qwen2-0.5b", None, True)]
    out = []
    for label, arch, shape_name, compressed in cells:
        cfg = replace(get_config(arch), remat_policy="full")
        if compressed:
            shape = ShapeConfig("train_8x128", 128, 8, "train")
        else:
            shape = SHAPES[shape_name]
        if not DRYRUN_FULL:
            cfg = cfg.reduced()
            shape = replace(shape, seq_len=32, global_batch=2)
        out.append((label, cfg, shape, compressed))
    return out


def compressed_step(torch, cfg, shape, device):
    """The smoke's compressed training step (keep ratio 0.25) of ``cfg`` on
    ``device``, its state and a batch: the same shapes on meta."""
    from repro_torch.distributed import grad_compression as gcomp
    from repro_torch.models.transformer import LM
    from repro_torch.train.loop import make_compressed_train_step
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    model = LM(cfg, device=device)
    if device == "meta":
        params = model.params()
        tokens = torch.empty((shape.global_batch, shape.seq_len),
                             dtype=torch.int32, device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        params = model.init(gen)
        tokens = torch.randint(0, cfg.vocab, (shape.global_batch,
                                              shape.seq_len), generator=gen,
                               device=device, dtype=torch.int32)
    opt = AdamW(AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10))
    state = {"inner": opt.init(params), "error": gcomp.init_error(params)}
    step = make_compressed_train_step(model, opt, 0.25)
    return model, step, [params, state, {"tokens": tokens}]


def step_for(torch, cfg, shape, compressed, device):
    from repro_torch.launch import dryrun as dr
    if compressed:
        return compressed_step(torch, cfg, shape, device)
    model, step, args = dr.prepare(cfg, shape, device)
    return model, step, list(args)


def run_step(step, args):
    """One step; a training step's new parameters and state become the
    next step's arguments (the decode step writes its cache in place)."""
    out = step(*args)
    if len(args) == 3:
        args[0], args[1] = out[0], out[1]
    return out


def device_busy_s(torch, fn):
    """(wall s, device busy s, the top device kernels) of ``fn()`` under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in events) / 1e6
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:6]
    return wall, busy, [[ev.key[:80], ev.count, ev.self_device_time_total]
                        for ev in top]


def card_check(torch, label, cfg, shape, compressed):
    """One step traced on meta, then the same step on the card under the
    counter: the counts must be equal, the counted matmul FLOPs over the
    device busy time at most the card's peak, and the meta trace's peak
    within 25% of the card's.  Prints time, rates and idle share."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.op_analysis import OpCounter
    cuda = DEVICE == "cuda"
    _, step, args = step_for(torch, cfg, shape, compressed, "meta")
    predicted, _ = dr.trace(step, args)
    del step, args
    release(torch)
    model, step, args = step_for(torch, cfg, shape, compressed, DEVICE)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counter = OpCounter()
    counter.track(args)
    with counter:
        out = run_step(step, args)
        del out
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    # the CPU runs the kernels' plain versions where meta and the card
    # count one launch: there the comparison leaves the wrappers out
    outside = None if cuda else "kernels."
    got = counter.totals_outside(outside)
    want = predicted.totals_outside(outside)
    row = {"label": label, "arch": cfg.name, "batch": shape.global_batch,
           "seq": shape.seq_len, **got,
           "predicted_peak": predicted.peak_bytes,
           "max_memory_allocated": peak}
    if got != want:
        raise AssertionError(f"{label}: counts on {DEVICE} {got} != {want} "
                             f"on meta")
    # the meta trace counts the launch that the card makes (the CPU runs
    # the plain version)
    sq = [(where, rec) for (op, where), rec in predicted.records.items()
          if op == "block_sqnorms"]
    if compressed:
        n = sum(p.numel() for p in args[0].values())
        n_pad = -(-n // 256) * 256
        # the bytes that block_sqnorms_case's bound counts
        want_bytes = n_pad * 4 + n_pad // 256 * 4
        if len(sq) != 1 or sq[0][1][0] != 1 or sq[0][1][2] != want_bytes:
            raise AssertionError(f"{label}: block_sqnorms records {sq}, "
                                 f"expected one launch of {want_bytes} B")
        row["block_sqnorms"] = {"where": sq[0][0], "bytes": sq[0][1][2]}
    row["top_bytes"] = [[op, where, v]
                        for v, op, where in counter.top(5, "bytes")]
    if cuda:
        if abs(predicted.peak_bytes - peak) > PEAK_TOL * peak:
            raise AssertionError(f"{label}: predicted peak "
                                 f"{predicted.peak_bytes} is not within "
                                 f"{PEAK_TOL:.0%} of {peak}")
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_step(step, args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        step_s = statistics.median(times)
        wall, busy, top = device_busy_s(torch,
                                        lambda: run_step(step, args))
        mm_rate = got["matmul_flops"] / busy
        if mm_rate > PEAK_BF16_FLOPS * FLOPS_TOL:
            raise AssertionError(f"{label}: {mm_rate:.4g} counted matmul "
                                 f"FLOP/s over busy time is above the peak")
        t_flops = got["matmul_flops"] / PEAK_BF16_FLOPS
        t_bytes = got["bytes"] / HBM_BYTES_PER_S
        row.update(step_s=step_s, step_times=times, profiled_wall_s=wall,
                   device_busy_s=busy, device_idle_share=1 - busy / wall,
                   matmul_flop_s=got["matmul_flops"] / step_s,
                   bytes_s=got["bytes"] / step_s,
                   matmul_flop_s_busy=mm_rate,
                   bytes_s_busy=got["bytes"] / busy,
                   bound_s=max(t_flops, t_bytes),
                   bound_by="operations" if t_flops > t_bytes else "bytes",
                   roofline_share=max(t_flops, t_bytes) / step_s,
                   peak_error=predicted.peak_bytes / peak - 1,
                   top_device=top)
        if row["bytes_s_busy"] > HBM_BYTES_PER_S:
            row["note"] = ("counted bytes over busy time exceed 3.35 TB/s: "
                           "operands reread from the 50 MB L2 count again")
    log("dryrun step: " + json.dumps(row))
    del model, step, args, counter, predicted
    release(torch)
    return row


def remat_check(torch, cfg, shape):
    """The compressed training cell for ``REMAT_STEPS`` steps under each
    policy from the same weights and batches: losses within rtol 1e-3;
    peak memory and step time of each."""
    from dataclasses import replace
    cuda = DEVICE == "cuda"
    rows = {}
    for policy in ("full", "dots_nb", "none"):
        release(torch)
        _, step, args = compressed_step(
            torch, replace(cfg, remat_policy=policy), shape, DEVICE)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            loss = run_step(step, args)[2]
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        rows[policy] = {"losses": losses, "step_s": times,
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated() if cuda
                            else None}
        del step, args
    log("remat: " + json.dumps(rows))
    ref = rows["full"]["losses"]
    for policy, row in rows.items():
        if not np.allclose(row["losses"], ref, rtol=1e-3, atol=0):
            raise AssertionError(f"remat: {policy} losses {row['losses']} "
                                 f"differ from full's {ref}")
    release(torch)
    return rows


def dryrun_phase(torch, kernels):
    """(a) the full sweep on meta, (b) three real steps at full width
    against their meta traces, (c) the three remat policies' losses.
    Every kernel's count is set to 0 before and read after: the phase's
    compressed steps run ``block_sqnorms`` and nothing else runs a kernel.
    Returns the phase's lines and its counts."""
    t0 = time.perf_counter()
    kernel_counts(kernels, reset=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        _, sweep_s = dryrun_sweep(d)
    steps = [card_check(torch, *cell) for cell in dryrun_cells()]
    _, cfg, shape, _ = dryrun_cells()[-1]
    remat = remat_check(torch, cfg, shape)
    launches = kernel_counts(kernels)
    others = {k: v for k, v in launches.items() if k != "block_sqnorms"}
    if DEVICE == "cuda" and not launches["block_sqnorms"] or any(
            others.values()):
        raise AssertionError(f"dryrun phase: launches {launches}")
    log(f"dryrun phase: phase_s={time.perf_counter() - t0} "
        f"sweep_s={sweep_s} launches={json.dumps(launches)}")
    return {"sweep_s": sweep_s, "steps": steps, "remat": remat,
            "launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs "
              "only on a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import Dataset, col, synth
    from repro_torch.core import cost_model
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bitpack_kernel as bp
    from repro_torch.kernels import grad_compress as gc
    from repro_torch.kernels import logical_reduce as lr
    from repro_torch.kernels import popcount as pc
    from repro_torch.kernels import word_logical as wl

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    nvcc_out = _build.build("logical_reduce", "word_logical",
                            "grad_compress", "popcount", "bitpack")
    log(f"kernel build_s={time.perf_counter() - t0} (parallel nvcc)")
    for name, out in nvcc_out.items():
        log(f"--- nvcc {name}\n{out.strip()}\n---")

    timer = Timer(torch)
    log(f"timer floor: an empty kernel measures {timer.floor_ms} ms")
    kernel_phase(torch, ops, wl, lr, timer)
    sq_row = block_sqnorms_phase(torch, gc, timer, QWEN2_PARAMS)

    memory_results = {}
    ds, stmts, launches_sorted, memory_results["sorted"] = main_path(
        "sorted", ROWS_SORTED, "lex", torch, wl, lr, synth, Dataset, col,
        must_launch=("kernel", "kernel_warm"))
    reduce_rows = main_path_case(torch, ops, lr, timer, ds, stmts, "sorted")
    profile_statements(torch, ds, stmts, "kernel", "andnot.")
    index_rows = index_profile_phase(torch, ops, pc, bp, wl, timer, ds)
    # kept for the store phase, which cuts its shards from the sorted rows;
    # its operands leave the card so that the phase's memory numbers are
    # its own
    sorted_ds = ds
    sorted_ds.index.dense_cache.clear()
    del ds
    torch.cuda.empty_cache()
    ds, stmts, launches_unsorted, memory_results["unsorted"] = main_path(
        "unsorted", ROWS_UNSORTED, "none", torch, wl, lr, synth, Dataset,
        col, must_launch=("kernel", "auto", "kernel_warm"))
    reduce_rows += main_path_case(torch, ops, lr, timer, ds, stmts,
                                  "unsorted")
    profile_statements(torch, ds, stmts, "auto", "andnot.")
    del ds
    release(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_served_") as kept:
        served = Path(kept) / "sorted"
        store_rows, launches_store = store_phase(
            torch, ops, wl, lr, timer, synth, Dataset, col, memory_results,
            sorted_ds, keep=served)
        reduce_rows += store_rows
        launches_serve = serve_phase(
            torch, wl, lr, Dataset, col, served, sorted_ds.table,
            sorted_ds.index.measure("sales"), memory_results["sorted"])
    del sorted_ds
    release(torch)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_root:
        model, params, report, sq_launches = training_path(
            torch, gc, wl, lr, str(Path(ckpt_root) / "main"))
        n_params = sum(p.numel() for p in params.values())
        if n_params != QWEN2_PARAMS:
            raise AssertionError(f"qwen2-0.5b has {n_params} parameters, "
                                 f"the kernel phase timed {QWEN2_PARAMS}")
        profile_train_step(torch, model, params)
        mask_phase(torch, gc, model, params)
        del model, params
        torch.cuda.empty_cache()
        restart_phase(torch, ckpt_root)
    release(torch)
    t0 = time.perf_counter()
    lm_lines = lm_serve_phase(torch, (wl, lr, gc, pc, bp))
    log(f"lm serve phase_s={time.perf_counter() - t0} models="
        f"{[line['arch'] for line in lm_lines]}")
    dryrun = dryrun_phase(torch, (wl, lr, gc, pc, bp))

    cm = cost_model.calibrate(device="cuda")
    log("calibrate: " + json.dumps({"dense_threshold": cm.dense_threshold,
                                    "source": cm.source,
                                    "samples": cm.samples}))

    main_launches = [v for runs in (launches_sorted, launches_unsorted,
                                    launches_store, launches_serve)
                     for v in runs.values()]
    reduce_row = max(reduce_rows, key=lambda r: r["bound_ms"])
    pair_row = index_rows["word_logical"]
    kernels = [{
        "name": "logical_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/logical_reduce.cu",
        "replaces": "src/repro/kernels/word_logical.py:74",
        "launches": sum(v["logical_reduce"] for v in main_launches),
        "max_abs_err": reduce_row["max_abs_err"],
        "ms": reduce_row["ms"], "plain_ms": reduce_row["plain_ms"],
        "bound_ms": reduce_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "word_logical", "route": "cuda",
        "source": "src/repro_torch/csrc/word_logical.cu",
        "replaces": "src/repro/kernels/word_logical.py:74",
        "launches": pair_row["launches"],
        "max_abs_err": pair_row["max_abs_err"],
        "ms": pair_row["ms"], "plain_ms": pair_row["plain_ms"],
        "bound_ms": pair_row["bound_ms"], "bound_by": "bytes",
        "library_ms": pair_row["library_ms"],
    }, {
        "name": "block_sqnorms", "route": "cuda",
        "source": "src/repro_torch/csrc/grad_compress.cu",
        "replaces": "src/repro/kernels/grad_compress.py:27",
        "launches": sq_launches + dryrun["launches"]["block_sqnorms"],
        "max_abs_err": sq_row["max_abs_err"],
        "ms": sq_row["ms"], "plain_ms": sq_row["plain_ms"],
        "bound_ms": sq_row["bound_ms"], "bound_by": "bytes",
        "library_ms": sq_row["library_ms"],
    }]
    for name, replaces in (
            ("popcount_total", "src/repro/kernels/popcount.py:37"),
            ("popcount_rows", "src/repro/kernels/popcount.py:66"),
            ("bitpack", "src/repro/kernels/bitpack_kernel.py:34")):
        row = index_rows[name]
        source = "bitpack.cu" if name == "bitpack" else "popcount.cu"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": row["launches"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"],
        })
    log(f"launches sorted={launches_sorted} unsorted={launches_unsorted} "
        f"store={launches_store} serve={launches_serve} "
        f"block_sqnorms={sq_launches} dryrun={dryrun['launches']} "
        f"index_profile="
        f"{ {k: r['launches'] for k, r in index_rows.items()} }; "
        f"logical_reduce row: {reduce_row['label']}")
    log(f"total_s={time.perf_counter() - t_start}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
