"""Percent of the traced window in which no kernel, copy or memset runs on
the card (busy: the union of their intervals over every stream)."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
