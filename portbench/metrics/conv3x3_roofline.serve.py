"""The bound of a forward's 3x3/s1 conv launches (each "same" and "down"
exchange part, from the reference's layer list) over the device time of
the kernels in `kernel_classes/conv3x3.json`, in the profiled slice of a
float serving cell."""

from portbench.common.work import conv3x3_bound

UNIT = "%"


def read(r):
    if r.driver != "serve" or r.traffic["int8"] or r.profile is None:
        return None
    t = r.class_seconds("conv3x3")
    if t <= 0:
        return None
    bound = conv3x3_bound(r.convs(), r.work["batch"], r.config["dtype"])[2]
    return 100.0 * bound * r.profile["units"] / t
