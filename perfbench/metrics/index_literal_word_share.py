"""Share of literal words in the run-list bitmaps the index build emits:
the counter ``index.words.literal`` over it plus ``index.words.fill``
(their marker words), as bumped under the build's spans.  The program
does not count the words of container-backed bitmaps."""
from perfbench.metrics import build_spans

build_spans.start()


def read(rec):
    b = build_spans.build(rec)
    if b is None:
        return None
    literal = b["counts"].get("index.words.literal", 0)
    fill = b["counts"].get("index.words.fill", 0)
    if literal + fill <= 0:
        return None
    return 100.0 * literal / (literal + fill)
