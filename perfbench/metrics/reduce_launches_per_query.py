"""``logical_reduce`` kernel launches over the traced window
(``repro_torch.kernels.logical_reduce.launches``) per query answered in
it: how much of the statements' work the planner sends to the card."""


def read(rec):
    if rec["queries_completed"] <= 0:
        return None
    return rec["launches"] / rec["queries_completed"]
