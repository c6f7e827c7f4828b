"""Serving layer: the bitmap-index query endpoint (``query_api``), the
shard worker of the scatter/gather tier (``worker_api``) and the LM's
batched greedy decode loop (``loop``)."""
