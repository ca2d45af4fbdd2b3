"""Host microseconds a hand-kernel entry takes (its checks, route, plan
or table, output and launch): the time of the wrapper spans (named as in
`kernels.LAUNCHES`) inside the profiled slice's ``predict`` spans over
their count."""

from portbench.common.spans import slice_requests

UNIT = "us"


def read(r):
    if r.driver != "serve":
        return None
    requests = slice_requests(r, "predict")
    if requests is None:
        return None
    from mgtpu_torch import kernels  # the entry spans are named as its counters

    calls = [s for _, spans in requests for s in spans if s["name"] in kernels.LAUNCHES]
    if not calls:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in calls) / len(calls) / 1e3
