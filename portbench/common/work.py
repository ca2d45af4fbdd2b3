"""The work a pass must do, from its layer shapes (`reference.mgnet.conv_shapes`),
and the least time one H100 could do it in. A frozen copy of the
arithmetic the port's chip checks used (`kernel_work`, `bound`, `i8_work`
and the peaks), fed from the benchmark's own list of layers, so a roofline
reads the same work whatever kernel implements it."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at its 700 W limit, by a
# configuration's ``dtype``: "tf32" is f32 with TF32 allowed in the convs
# (PyTorch's default for cuDNN), so its ceiling is TF32's; "f32", exact
# f32, has the rate outside the tensor cores.
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_HBM_BYTES = 3.35e12
ITEMSIZE = {"bf16": 2, "tf32": 4, "f32": 4, "int8": 2}  # int8's activations are dequantized to bf16


def kernel_work(kernel, shape, batch, itemsize=2):
    """(operations, bytes) that one launch of a 3x3/s1/p1 conv kernel at
    (H, W, Ci, Co) must do at ``batch``: each input read once, each output
    written once; multiply-adds (2 each) on the taps inside the image
    (along H, 3H - 2 of the 3H taps). ``conv3x3_bn_relu_in`` also reads
    its prologue's f32 scale and shift."""
    h, w, ci, co = shape
    px = batch * h * w
    nbytes = itemsize * (px * ci + 9 * ci * co + px * co) + 4 * co
    if kernel == "conv3x3_bn_relu_in":
        nbytes += 8 * ci
    return 2 * batch * (3 * h - 2) * (3 * w - 2) * ci * co, nbytes


def bound(flops, nbytes, peak):
    """(seconds, "operations" or "bytes"): the larger of operations over
    ``peak`` and bytes over HBM's, and which one it is."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def out_size(n, k, stride, before, after):
    return (n + before + after - k) // stride + 1


def i8_work(key, batch, itemsize=2):
    """(operations, bytes) of one int8 conv launch ``key`` = (h, w, ci, co,
    k, stride, pad, has_in, has_bias): multiply-adds on the taps inside x,
    x and w read once (int8), the activation scale and the dequant vector
    (f32), the part sum and the bias where the launch takes them, y
    written once in ``itemsize`` bytes."""
    h, w, ci, co, k, stride, pad, has_in, has_bias = key
    oh, ow = out_size(h, k, stride, pad, pad), out_size(w, k, stride, pad, pad)

    def taps(n, m):
        return sum(sum(0 <= o * stride - pad + t < n for t in range(k)) for o in range(m))

    out = batch * oh * ow * co
    nbytes = (batch * h * w * ci + k * k * ci * co + 4 + 4 * co + 4 * co * has_bias
              + itemsize * out * (1 + has_in))
    return 2 * batch * taps(h, oh) * taps(w, ow) * ci * co, nbytes


def conv3x3_launches(convs, train=False):
    """[(kernel, (H, W, Ci, Co))] of the launches the port's 3x3 kernels
    take in one forward: every "same" and "down" part of a 3x3/s1/p1 conv
    (an exact-2x "up" part goes to a transposed conv). In a training
    forward a residual layer's second stage reads its "same" part
    un-normalized (`conv3x3_bn_relu_in`)."""
    out = []
    for cv in convs:
        if (cv["k"], cv["stride"], cv["pad"]) != (3, 1, 1):
            continue
        _, _, oh, ow = cv["parts"][0]
        for kind, ci, h, w in cv["parts"]:
            if kind == "up" and (h, w) == (oh, ow):
                continue
            name = "conv3x3_bn_relu_in" if train and cv["stage2"] and kind == "same" else "conv3x3"
            out.append((name, (h, w, ci, cv["co"])))
    return out


def conv3x3_bound(convs, batch, dtype, train=False):
    """(operations, bytes, seconds) of one forward's 3x3 launches at
    ``batch``, operands and operations in ``dtype``: each launch's bound,
    summed."""
    flops = nbytes = secs = 0
    for kernel, shape in conv3x3_launches(convs, train):
        f, b = kernel_work(kernel, shape, batch, ITEMSIZE[dtype])
        flops, nbytes, secs = flops + f, nbytes + b, secs + bound(f, b, PEAK[dtype])[0]
    return flops, nbytes, secs


def i8_keys(convs):
    """The int8 conv launches of one int8 forward: one per part of every
    conv (an "up" part upsampled to the conv's resolution first), each
    after the first adding into the part sum, the last adding the bias."""
    keys = []
    for cv in convs:
        n = len(cv["parts"])
        for j, (_, ci, h, w) in enumerate(cv["parts"]):
            keys.append((h, w, ci, cv["co"], cv["k"], cv["stride"], cv["pad"], j > 0, j == n - 1))
    return keys


def i8_bound(convs, batch):
    """(operations, bytes, seconds) of one int8 forward's conv launches."""
    flops = nbytes = secs = 0
    for key in i8_keys(convs):
        f, b = i8_work(key, batch)
        flops, nbytes, secs = flops + f, nbytes + b, secs + bound(f, b, PEAK["int8"])[0]
    return flops, nbytes, secs
