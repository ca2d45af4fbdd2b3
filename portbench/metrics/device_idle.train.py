"""The share of the profiled slice's wall time in which no kernel, copy or
set runs on the card (the union of the device's intervals)."""

UNIT = "%"


def read(r):
    if r.driver != "train" or r.profile is None or r.profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.profile["busy_s"] / r.profile["window_s"])
