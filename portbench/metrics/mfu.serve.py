"""Model operations of a forward (2 x the reference formulation's
multiply-adds an image) at the window's images a second, over the card's
dense peak in the type the convs run in (int8 where the traffic serves
int8, else the configuration's ``dtype``)."""

from portbench.common.work import PEAK

UNIT = "%"


def read(r):
    if r.driver != "serve":
        return None
    peak = "int8" if r.traffic["int8"] else r.config["dtype"]
    return 100.0 * 2 * r.macs_per_image() * r.rate / PEAK[peak]
