"""Share of the traced window in which nothing ran on the card: 1 - the
union of the trace's device intervals (kernels, copies, sets) over the
window's wall time."""


def read(rec):
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
