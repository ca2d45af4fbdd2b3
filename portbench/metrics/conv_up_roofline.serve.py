"""The bound of a forward's exchange "up" parts (each exact-2x "up" part
under a 3x3 conv, from the reference's layer list: `common/work_up.py`)
over the device time of the kernels in `kernel_classes/conv_up.json`, in
the profiled slice of a float serving cell. None unless every ``predict``
of the slice holds one ``conv_up3`` span (`mgtpu_torch.nn._conv_up3`) for
each of the reference's up parts, so the bound covers what ran."""

from portbench.common.spans import slice_requests
from portbench.common.work_up import up_bound, up_parts

UNIT = "%"


def read(r):
    if r.driver != "serve" or r.traffic["int8"] or r.profile is None:
        return None
    requests = slice_requests(r, "predict")
    n = len(up_parts(r.convs()))
    if requests is None or not n or any(sum(s["name"] == "conv_up3" for s in spans) != n
                                        for _, spans in requests):
        return None
    t = r.class_seconds("conv_up")
    if t <= 0:
        return None
    bound = up_bound(r.convs(), r.work["batch"], r.config["dtype"])[2]
    return 100.0 * bound * r.profile["units"] / t
