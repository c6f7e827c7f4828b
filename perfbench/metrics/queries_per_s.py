"""Queries answered per second: every query of the window's whole decks
that was answered, over the seconds from the window's opening to the last
of their answers.  A query of several statements counts once."""


def read(rec):
    done = [r["t_done"] for r in rec["records"] if r["ok"]]
    if not done:
        return None
    return len(done) / max(done)
