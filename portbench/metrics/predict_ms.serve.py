"""Host milliseconds of the program's ``predict`` span (`Server.predict`,
the whole call), the mean over the profiled slice's batches: the inside
twin of `dispatch_ms.serve`."""

from portbench.common.spans import mean_ms, slice_requests

UNIT = "ms"


def read(r):
    if r.driver != "serve":
        return None
    requests = slice_requests(r, "predict")
    return None if requests is None else mean_ms(requests)
