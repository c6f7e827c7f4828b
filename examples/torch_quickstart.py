"""Quickstart on the PyTorch port: the ``Dataset`` façade — sort, index,
persist, query and aggregate a fact table with one object, on the card.

The counterpart of ``examples/quickstart.py``: the same lifecycle, the same
printed lines and the same self-checks against the NumPy row oracle, with
every dataset on ``--device`` (the executor's dense path, the fused
``logical_reduce`` kernel, runs there wherever the planner picks it).

The lifecycle this walks through:

    Dataset.from_rows(table, sort="lex", shards=4, spill_dir=...)
        -> external-merge sort (spilled runs) -> streaming sharded build
    Dataset.from_rows(table, sort="none")  # container="auto" by default:
        -> Roaring-style per-chunk array/dense/run encoding for unsortable
           tables, bit-identical ops, collapses to plain EWAH when sorted
    .save(dir)   -> durable per-shard .ridx files + manifest
    Dataset.open(dir)                 -> zero-copy mmap warm start
    .query().where(e).count()         -> compressed-domain popcount
    .query().where(e).group_by(c).count() -> bincount-shaped aggregation
    .query().top_k(c, k)              -> heavy hitters, no rows decompressed
    Dataset.from_rows(..., measures={"sales": arr})  -> v4 measure sidecar
    .query().where(e).sum("sales")    -> interval-sliced scalar aggregates
    .group_by(a, b).sum("sales")      -> two-column measure matrices
    .top_k(c, k, measure="sales")     -> shard-pruned sum-ranked top-k
    .serve().sql("SELECT sum(sales) FROM t WHERE ... GROUP BY day")
    .serve()                          -> pooled caching HTTP service
    Dataset.open(dir, live=True)      -> WAL-backed mutable layer
    .append(rows) / .delete(e)        -> delta index + compressed tombstones
    .compact()                        -> re-sorted base, new store epoch

Every layer stays importable (sorting / IndexBuilder / store /
ShardedIndex / QueryService) — the façade just owns their composition.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` runs the kernels' plain versions.  ``--rows`` (default 50,000, the
reference's) sizes the fact table.  ``main`` returns the seconds each
section took.
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import BitmapIndex, Dataset, col, lex_sort, synth
from repro_torch.core import query as q
from repro_torch.kernels.ops import resolve_device
from repro_torch.serve.query_api import expr_to_json


def main(argv=None):
    """Runs the walk-through; returns {section: seconds}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=50_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = tempfile.mkdtemp(prefix="repro-torch-quickstart-")
    try:
        return _run(workdir, args.rows, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(workdir, n_rows, device):
    seconds = {}
    clock = [time.perf_counter()]

    def lap(section):
        now = time.perf_counter()
        seconds[section] = now - clock[0]
        clock[0] = now

    rng = np.random.default_rng(0)

    # A fact table: 50k facts, 3 dimensions of very different cardinalities
    table = synth.census_like_table(n_rows, rng)
    ranked, uniques = synth.factorize(table)
    cards = [len(u) for u in uniques]
    names = ["region", "day", "user"]
    print(f"fact table: {len(ranked)} rows, cardinalities {cards}")

    # --- the paper's recipe, one call -------------------------------------
    # sort="lex" picks the §4.3 frequency-aware column order and runs an
    # external-merge sort; spill_dir sends the chunk-sorted runs to disk and
    # streams merged chunks straight into per-shard index builders, so the
    # whole sort->build pipeline is O(chunk + partition) memory.
    ds = Dataset.from_rows(ranked, names, sort="lex", k=1, shards=4,
                           spill_dir=os.path.join(workdir, "runs"),
                           chunk_rows=8192, device=device)
    shuffled = ranked[rng.permutation(len(ranked))]
    raw = Dataset.from_rows(shuffled, names, sort="none", k=1,
                            container="run",  # the paper's pure-EWAH baseline
                            device=device)
    print(f"index size shuffled: {raw.size_words} words, "
          f"sorted: {ds.size_words} words "
          f"-> sorting gain {raw.size_words / ds.size_words:.2f}x "
          f"({ds.n_shards} shards, col order {ds.sort_order})")

    # --- hybrid containers when you can't sort ------------------------------
    # sort="none" defaults to container="auto": each bitmap is chunked into
    # 2^16-bit word-aligned chunks and the cost model picks sorted-array /
    # dense-words / run per chunk (whichever is smallest).  Sorted builds
    # default to container="run" — plain run-lists, byte-identical stores;
    # force "run" yourself for byte-stable files or interval-heavy reads.
    hybrid = Dataset.from_rows(shuffled, names, sort="none", k=1,
                               device=device)
    print(f"containers on the shuffled table: {hybrid.size_words} words "
          f"-> {raw.size_words / hybrid.size_words:.2f}x smaller than pure "
          f"EWAH without sorting (calibrate the array/dense cutoff once "
          f"with CostModel.calibrate_containers, persist via "
          f"$REPRO_COST_MODEL)")
    assert hybrid.query().where(col("region") == 0).count() == \
        raw.query().where(col("region") == 0).count()
    lap("build")

    # --- statements: filters + aggregates ---------------------------------
    # the spill build retains no rows; recover the sorted view for the
    # oracle checks with the same order the dataset sorted under
    sorted_table = ranked[lex_sort(ranked, ds.sort_order)]
    v_region = int(sorted_table[0, 0])
    v_day = int(sorted_table[0, 1])
    where = ((col("region") == v_region)
             & ~col("day").isin([v_day, v_day + 1]))
    sel = ds.query().where(where)

    n = sel.count()  # compressed-domain popcount, no rows materialized
    print(f"\nwhere {where}\ncount: {n}")

    by_day = sel.group_by("day").count()  # np.bincount-shaped vector
    top = sel.top_k("day", 3)
    print(f"group_by(day): {int(by_day.sum())} rows over "
          f"{int((by_day > 0).sum())} days; top-3 {top}")

    # bit-identical to the NumPy oracle on the sorted rows
    mask = q.naive_eval(sorted_table, where, names=names)
    assert n == int(mask.sum())
    assert np.array_equal(by_day, np.bincount(sorted_table[mask, 1],
                                              minlength=ds.card("day")))
    rows = sel.rows(limit=5)
    print(f"first rows: {rows.tolist()} (rows() is the only terminal that "
          f"decompresses)")
    print("\nplan:")
    print(sel.explain())
    lap("statements")

    # --- persist + warm start ----------------------------------------------
    idx_dir = os.path.join(workdir, "idx")
    ds.save(idx_dir)
    t0 = time.perf_counter()
    warm = Dataset.open(idx_dir, device=device)  # mmap: no payload read
    open_ms = (time.perf_counter() - t0) * 1e3
    wsel = warm.query().where(where)
    assert wsel.count() == n
    assert np.array_equal(wsel.group_by("day").count(), by_day)
    print(f"\nsaved to {idx_dir}; reopened mmap'd in {open_ms:.1f} ms — "
          f"same counts from the store files")
    lap("save_open")

    # --- serving ------------------------------------------------------------
    # the service executes statements over HTTP too:
    #   {"select": {"count": true}, "where": ...}
    #   {"select": {"group_count": "day"}, "where": ...}
    #   {"select": {"top_k": {"col": "day", "k": 3}}, "where": ...}
    svc = warm.serve(pool_workers=4, cache_entries=128)
    out = svc.statement({"select": {"group_count": "day"},
                         "where": expr_to_json(where)})
    again = svc.statement({"select": {"count": True},
                           "where": expr_to_json(where)})
    assert out["counts"] == by_day.tolist() and again["count"] == n
    print(f"service: group_count cached={out['cached']}, "
          f"count={again['count']} "
          f"(cache {svc.stats()['cache']['misses']} misses)")
    svc.close()
    lap("serve")

    # --- OLAP dashboard: measures + sum/avg + SQL ---------------------------
    # declare numeric measure columns and the store grows a columnar
    # sidecar (format v4); sum/avg/min/max, two-column group-by and
    # measure-ranked top-k all evaluate by slicing the mmap'd measure
    # arrays with the filter's EWAH run intervals — no rows reconstructed.
    # (spill_dir builds don't take measures: the row permutation never
    # materializes there.)
    sales = rng.integers(0, 1_000, len(ranked)).astype(np.int64)
    facts = Dataset.from_rows(ranked, names, sort="lex", k=1, shards=2,
                              measures={"sales": sales}, device=device)
    olap_dir = os.path.join(workdir, "olap")
    facts.save(olap_dir)                      # v4 store: bitmaps + sidecar
    facts = Dataset.open(olap_dir, device=device)  # measures mmap back

    fq = facts.query().where(col("region") == v_region)
    total = fq.sum("sales")
    by_day_region = fq.group_by("day", "region").sum("sales")
    leaders = facts.query().top_k("user", 3, measure="sales")
    print(f"\ndashboard: sum(sales)={total}, avg={fq.avg('sales'):.1f}, "
          f"group_by(day,region) -> {by_day_region.shape} matrix, "
          f"top spenders {leaders}")

    # bit-exact against the NumPy row oracle (sales in the dataset's
    # sorted row order)
    s_sorted = sales[lex_sort(ranked, facts.sort_order)]
    s_mask = sorted_table[:, 0] == v_region
    assert total == int(s_sorted[s_mask].sum())
    g = np.zeros((facts.card("day"), facts.card("region")), dtype=np.int64)
    np.add.at(g, (sorted_table[s_mask, 1], sorted_table[s_mask, 0]),
              s_sorted[s_mask])
    assert np.array_equal(by_day_region, g)

    # the service answers the same statement in JSON or SQL — both
    # compile to one statement object and share cache entries
    dash = facts.serve(pool_workers=2)
    out = dash.statement({"select": {"sum": "sales", "by": ["day"]},
                          "where": {"op": "eq", "col": "region",
                                    "value": v_region}})
    via_sql = dash.sql(f"SELECT sum(sales) FROM t "
                       f"WHERE region = {v_region} GROUP BY day")
    assert via_sql["values"] == out["values"] and via_sql["cached"]
    top_sql = dash.sql("SELECT sum(sales) FROM t GROUP BY user LIMIT 3")
    assert [tuple(t) for t in top_sql["top"]] == leaders
    print(f"service: SQL group-by cached={via_sql['cached']}; "
          f"LIMIT 3 rewrote into pruned top-k {top_sql['top']}")
    # on the cluster tier the same statements degrade instead of failing:
    # with every replica of a shard down the response carries
    # exact=false + missing_shards + covered_rows and is never cached
    # (see examples/torch_cluster_quickstart.py for the worker-kill demo)
    dash.close()
    lap("dashboard")

    # --- streaming ingest: append / delete / compact ------------------------
    # the sorted base is immutable; mutations go to a WAL-framed delta
    # index + compressed tombstones, reads see (base + delta) AND NOT dead
    live = Dataset.open(idx_dir, live=True, device=device)
    n0 = live.query().count()
    live.append(ranked[:500])              # visible to the next statement
    assert live.query().count() == n0 + 500
    removed = live.delete(col("region") == v_region)  # compressed-domain
    stats = live.index.stats()
    print(f"\nlive: appended 500, tombstoned {removed} "
          f"(delta {stats['delta_rows']} rows, WAL {stats['wal_bytes']} B)")

    info = live.compact()  # drain delta through the external-merge sort:
    # fresh sorted shard files under a new epoch, manifest = atomic cutover
    assert live.query().count() == n0 + 500 - removed
    print(f"compacted -> epoch {info['epoch']}, {info['n_rows']} rows, "
          f"{info['size_words']} words")

    reopened = Dataset.open(idx_dir, device=device)  # WAL: live attaches
    assert reopened.query().count() == n0 + 500 - removed
    live.index.close()
    reopened.index.close()

    # power users: the layers are still right there
    assert isinstance(warm.index.shards[0], BitmapIndex)
    lap("live")
    return seconds


if __name__ == "__main__":
    main()
