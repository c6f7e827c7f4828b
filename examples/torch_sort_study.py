"""Sort study on the PyTorch port: the paper's central experiment as one
readable script, its table and queries on the card.

Compares Random-shuffle / Random-sort / Block-sort / Lex / Gray on one
dataset and prints the compression + query-speed table, as
``examples/sort_study.py`` does for the JAX package, with the same rows
and the same index words.  The fact table lives on the device, which
gathers each sort's rows; the sorts and the index builder are the port's
host code, as the reference's are.  Each equality query (two bitmaps ANDed
at ``k=2``) runs the executor's kernel path on the device and is checked
against the index's host ``equality_rows``.

    PYTHONPATH=src python examples/torch_sort_study.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` runs the kernels' plain versions.  ``--rows`` (default 100,000, the
reference's) sizes the table.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (BitmapIndex, ColumnEncoder, block_sort, col,
                              gray_sort, lex_sort, random_shuffle,
                              random_sort, synth)
from repro_torch.core.executor import execute_rows
from repro_torch.kernels.ops import resolve_device


def main(argv=None):
    """Prints the table; returns its rows, one dict a method."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=100_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    t = synth.zipf_table(args.rows, 3, s=1.0, card=1500, rng=rng)
    table, _ = synth.factorize(t)
    cards = [int(table[:, c].max()) + 1 for c in range(table.shape[1])]
    k = 2
    encs = [ColumnEncoder(c, k) for c in cards]
    on_device = torch.from_numpy(table).to(device)

    methods = {
        "random-shuffle": lambda: random_shuffle(table, rng),
        "random-sort": lambda: random_sort(table, rng),
        "block-sort(10)": lambda: block_sort(table, 10),
        "lex": lambda: lex_sort(table),
        "gray": lambda: gray_sort(table, encs),
    }
    print(f"{'method':<16}{'sort_s':>8}{'index_s':>9}{'words':>10}"
          f"{'vs_shuffle':>11}{'query_ms':>10}")
    base = None
    rows = []
    for name, fn in methods.items():
        t0 = time.time()
        perm = fn()
        t_sort = time.time() - t0
        t0 = time.time()
        sorted_rows = on_device[torch.from_numpy(perm).to(device)]
        idx = BitmapIndex.build(sorted_rows.cpu().numpy(), k=k, cards=cards)
        t_index = time.time() - t0
        qvals = rng.integers(0, cards[2], 12)
        # one query first, outside the clock: on a fresh machine it builds
        # the kernel (the index keeps each operand it uploads)
        execute_rows(idx, col(2) == int(qvals[0]), backend="kernel",
                     device=device)
        t0 = time.time()
        got = [execute_rows(idx, col(2) == int(v), backend="kernel",
                            device=device) for v in qvals]
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_query = (time.time() - t0) / 12 * 1e3
        for v, r in zip(qvals, got):
            if not np.array_equal(r, idx.equality_rows(2, int(v))):
                raise AssertionError(f"{name}: column 2 == {v} on the "
                                     f"device differs from equality_rows")
        if base is None:
            base = idx.size_words
        print(f"{name:<16}{t_sort:>8.2f}{t_index:>9.2f}{idx.size_words:>10}"
              f"{base / idx.size_words:>10.2f}x{t_query:>10.2f}")
        rows.append({"method": name, "words": idx.size_words,
                     "sort_s": t_sort, "index_s": t_index,
                     "query_ms": t_query})
    return rows


if __name__ == "__main__":
    main()
