"""Hand-kernel launches a batch: the launch counts of the spans inside
each ``predict`` of the profiled slice, summed, over its batches."""

from portbench.common.spans import slice_requests

UNIT = "launches"


def read(r):
    if r.driver != "serve":
        return None
    requests = slice_requests(r, "predict")
    if requests is None:
        return None
    return sum(s["launches"] for _, spans in requests for s in spans) / len(requests)
