"""Model operations of the saliency forwards (2 x the reference
formulation's multiply-adds an image, 1 + 841 images a sample) at the
window's samples a second, over the card's dense peak for the
configuration's ``dtype`` (TF32's for "tf32": f32 with TF32 allowed)."""

from portbench.common.work import PEAK

UNIT = "%"


def read(r):
    if r.driver != "saliency":
        return None
    return 100.0 * 2 * r.macs_per_image() * r.work["stack"] * r.rate / PEAK[r.config["dtype"]]
