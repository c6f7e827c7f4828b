"""Shards at work at once, on average, while any was: the seconds of the
window's ``shard.task`` spans over the union of their intervals (1.0: the
shard threads ran one at a time)."""
from perfbench.metrics import spans

spans.start()


def read(rec):
    ss = spans.spans(rec, "shard.task")
    union = spans.union_seconds(ss)
    if union <= 0:
        return None
    return spans.seconds(ss) / union
