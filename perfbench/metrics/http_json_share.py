"""Share of the client's waiting that the service did not spend in its
statements (HTTP, JSON both ways, the handler and the pool hand-off):
1 - the window's ``statements/<kind>/seconds`` counters over the sum of
the client's query latencies."""
from perfbench.metrics import spans

spans.start()


def read(rec):
    served = spans.bumps(rec, spans.statement_seconds)
    waited = sum(r["t_done"] - r["t_send"] for r in rec["records"])
    if not served or waited <= 0:
        return None
    return 100.0 * (1.0 - served / waited)
