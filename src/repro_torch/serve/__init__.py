"""Serving layer: the bitmap-index query endpoint (``query_api``) and the
shard worker of the scatter/gather tier (``worker_api``).  The reference's
LM decode loop is not ported yet."""
