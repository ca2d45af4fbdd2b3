"""The bound of a training step's forward 3x3/s1 conv launches (each
"same" and "down" exchange part, from the reference's layer list) over
the device time of the kernels in `kernel_classes/conv3x3.json`, in the
profiled slice."""

from portbench.common.work import conv3x3_bound

UNIT = "%"


def read(r):
    if r.driver != "train" or r.profile is None:
        return None
    t = r.class_seconds("conv3x3")
    if t <= 0:
        return None
    bound = conv3x3_bound(r.convs("train"), r.work["batch"], r.config["dtype"],
                          train=True)[2]
    return 100.0 * bound * r.profile["units"] / t
