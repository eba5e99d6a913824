"""The card's idle share in the traced stretch: the time no kernel or copy
ran, %."""


def read(r):
    s = r.stretch
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
