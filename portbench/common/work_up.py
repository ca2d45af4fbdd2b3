"""The work of a forward's exchange "up" parts (`mgtpu_torch.nn._conv_up3`),
from the reference's layer list (`reference.mgnet.conv_shapes`), and the
least time one H100 could do it in (`work.bound`).

A 3x3/s1/p1 conv of ``nearest_up2(c)``, a coarse ``c`` at half the
output's grid, reads each fine pixel's 3x3 taps from 2x2 coarse pixels:
the 4x4 stride-2 identity that `_conv_up3` computes as a transposed
conv. So the least work is 4 taps of ``Ci x Co`` a fine output pixel,
less the taps that fall outside the image at its edges (``2 oh - 2``
coarse taps along H, as `work.kernel_work` counts ``3 H - 2``); the
coarse input read once, the fine output written once, and the 3x3
weights, in the configuration's operand type."""

from __future__ import annotations

from portbench.common.work import ITEMSIZE, PEAK, bound


def up_parts(convs):
    """[(oh, ow, ci, co)] of one forward's exact-2x "up" parts under a
    3x3/s1/p1 conv: ``oh, ow`` the fine output's grid (even: an odd one's
    coarse grid is its ceil half, and the part goes whole to a 3x3
    kernel), ``ci`` the coarse part's channels."""
    out = []
    for cv in convs:
        if (cv["k"], cv["stride"], cv["pad"]) != (3, 1, 1):
            continue
        _, _, oh, ow = cv["parts"][0]
        if oh % 2 == 0 and ow % 2 == 0:
            out += [(oh, ow, ci, cv["co"]) for kind, ci, _, _ in cv["parts"] if kind == "up"]
    return out


def up_work(part, batch, itemsize=2):
    """(operations, bytes) of one up part ``(oh, ow, ci, co)`` at ``batch``."""
    oh, ow, ci, co = part
    flops = 2 * batch * (2 * oh - 2) * (2 * ow - 2) * ci * co
    nbytes = itemsize * (batch * (oh // 2) * (ow // 2) * ci + 9 * ci * co + batch * oh * ow * co)
    return flops, nbytes


def up_bound(convs, batch, dtype):
    """(operations, bytes, seconds) of one forward's up parts at ``batch``,
    operands and operations in ``dtype``: each part's bound, summed."""
    flops = nbytes = secs = 0
    for part in up_parts(convs):
        f, b = up_work(part, batch, ITEMSIZE[dtype])
        flops, nbytes, secs = flops + f, nbytes + b, secs + bound(f, b, PEAK[dtype])[0]
    return flops, nbytes, secs
