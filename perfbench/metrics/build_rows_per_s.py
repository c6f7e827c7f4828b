"""Fact rows over the host seconds of ``Dataset.from_rows``: the sort, the
encoding, the index build and the cut into shards."""


def read(rec):
    return rec["n_rows"] / rec["build_s"]
