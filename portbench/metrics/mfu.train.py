"""Model operations of a training step (3 x 2 x the reference formulation's
multiply-adds an image) at the window's images a second, over the card's
dense peak for the configuration's ``dtype`` (bf16's, or TF32's for
"tf32": f32 with TF32 allowed)."""

from portbench.common.work import PEAK

UNIT = "%"


def read(r):
    if r.driver != "train":
        return None
    return 100.0 * 6 * r.macs_per_image() * r.rate / PEAK[r.config["dtype"]]
