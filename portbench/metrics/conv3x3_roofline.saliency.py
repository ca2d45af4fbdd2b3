"""The bound of the saliency forwards' 3x3/s1 conv launches (each "same"
and "down" exchange part, from the reference's layer list, 1 + 841
images a sample) over the device time of the kernels in
`kernel_classes/conv3x3.json`, in the profiled slice; f32 operands,
operations at the peak of the configuration's ``dtype`` (TF32's for
"tf32": the precision the configuration allows, whatever a kernel runs)."""

from portbench.common.work import conv3x3_bound

UNIT = "%"


def read(r):
    if r.driver != "saliency" or r.profile is None:
        return None
    t = r.class_seconds("conv3x3")
    if t <= 0:
        return None
    images = r.work["group"] * r.work["stack"]
    bound = conv3x3_bound(r.convs(), images, r.config["dtype"])[2]
    return 100.0 * bound * r.profile["units"] / t
