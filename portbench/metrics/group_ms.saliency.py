"""Host milliseconds of the program's ``group`` span (`GroupStep`, the
whole call: input copy, stack, forward, probe), the mean over the
profiled slice's groups."""

from portbench.common.spans import mean_ms, slice_requests

UNIT = "ms"


def read(r):
    if r.driver != "saliency":
        return None
    requests = slice_requests(r, "group")
    return None if requests is None else mean_ms(requests)
