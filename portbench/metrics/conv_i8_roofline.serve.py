"""The bound of an int8 forward's conv launches (every part of every
quantized conv, from the reference's layer list: operations at the int8
peak, bytes with the part sums' reads) over the device time of the
kernels in `kernel_classes/conv_i8.json`, in the profiled slice."""

from portbench.common.work import i8_bound

UNIT = "%"


def read(r):
    if r.driver != "serve" or not r.traffic["int8"] or r.profile is None:
        return None
    t = r.class_seconds("conv_i8")
    if t <= 0:
        return None
    return 100.0 * i8_bound(r.convs(), r.work["batch"])[2] * r.profile["units"] / t
