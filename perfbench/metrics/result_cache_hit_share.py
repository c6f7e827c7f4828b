"""Share of the window's statements that the service's result LRU
answered: ``/stats`` ``cache`` hits / (hits + misses), read at the
window's opening and close.  Nothing to read when no statement reached
the cache."""


def read(rec):
    a, b = rec["cache_start"], rec["cache_end"]
    hits = b["hits"] - a["hits"]
    misses = b["misses"] - a["misses"]
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
