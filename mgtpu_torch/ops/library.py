"""The port's forward kernels as ``torch.library`` custom ops in the
``mgtpu`` namespace, so that ``torch.export`` keeps them in the graph it
traces and a saved ``.pt2`` program launches them when it runs
(`mgtpu_torch.tools.export_model`, `mgtpu_torch.tools.serve_exported`).

    mgtpu::conv3x3              `cuda_conv.conv3x3_forward`
    mgtpu::conv3x3_bn_relu_in   `cuda_conv.conv3x3_bn_relu_in_forward`
    mgtpu::maxpool2             `cuda_pool.maxpool2_forward`
    mgtpu::conv_i8              `cuda_conv_i8.conv_i8`, out of place
    mgtpu::quant_i8             `quant.quant_i8`
    mgtpu::quant_i8_group       `quant.quant_i8_group`

Each op's implementation is the wrapper's own forward: on a CUDA tensor
it launches the kernel through `mgtpu_torch.kernels.launch` (built at
first use, counted in ``kernels.LAUNCHES`` and ``ROUTES``) or raises; on
a CPU tensor it runs the plain version. Each has a fake implementation
that gives the output's shapes and dtypes only, which is all the tracer
sees: the device pointers, the SM count and the alignments the designs
are picked from are read when the op runs. The pool backward is not an
op: an exported program serves, as the JAX package's does.

The ops are defined with the dispatcher's own API (a schema, one
implementation for the CPU and the CUDA key, a fake), not with
``torch.library.custom_op``, whose Python layers (an autograd wrapper
and an aliasing check on every call) add host time to every call, and an
exported forward is host-bound (``chip_smoke.py`` phase 30 times each op
against its wrapper on the card). No op has an autograd kernel: the
programs serve. The
wrappers call the ops only while ``torch.compiler.is_exporting()``: the
eager forward calls the wrappers' forwards directly, without the
dispatcher. Importing this module registers the ops; a program that
loads a ``.pt2`` imports it first.

Two ops differ from their eager call in what they return, because a
custom op's outputs may not alias its inputs: ``conv_i8`` writes a new
tensor where the eager call adds into the part sum ``y_in`` in place
(the kernel reads ``y_in`` and writes the output through two pointers;
the bits are the same; ``conv3x3``'s part sum ``y_in`` is read alone
in both), and ``quant_i8`` returns, beside the int8
values, the (absmax, scale) pair of a dynamic quantize, or an empty
tensor where the scale was given (the caller keeps its own);
``quant_i8_group`` the (absmax, scale) rows of its dynamic members, a
(2, 0) tensor where every scale was given. A group's "up" sizes travel
as one flat list, (oh, ow) a member, (0, 0) for a part without up.

The convs' per-side H padding (an H-slab's halo mode) is in the schemas
with defaults: ``conv3x3``'s ``pad_top=1, pad_bottom=1``, ``conv_i8``'s
``pad_top=None, pad_bottom=None`` (its ``pad``), so a program traced
before they existed, or without a mesh, keeps the symmetric launch;
``conv3x3``'s part sum ``y_in=None`` comes last for the same reason.
"""

from __future__ import annotations

import torch

from mgtpu_torch.ops import cuda_conv, cuda_conv_i8, cuda_pool, quant


def conv3x3(x, w, b, relu_out, with_stats, pad_top=1, pad_bottom=1, y_in=None):
    return cuda_conv.conv3x3_forward(x, w, b, relu_out=relu_out, with_stats=with_stats,
                                     pad_top=pad_top, pad_bottom=pad_bottom, y_in=y_in)


def conv3x3_bn_relu_in(x, w, b, scale, shift, relu_out, with_stats, pad_top=1, pad_bottom=1):
    return cuda_conv.conv3x3_bn_relu_in_forward(x, w, b, scale, shift, relu_out=relu_out,
                                                with_stats=with_stats, pad_top=pad_top,
                                                pad_bottom=pad_bottom)


def _conv3x3_fake(x, w, b, relu_out, with_stats, pad_top=1, pad_bottom=1, y_in=None):
    n, _, wd, _ = x.shape
    co = w.shape[3]
    h = cuda_conv.out_rows(x, pad_top, pad_bottom)
    return x.new_empty((n, h, wd, co)), x.new_empty((2, co), dtype=torch.float32)


def _conv3x3_bn_relu_in_fake(x, w, b, scale, shift, relu_out, with_stats, pad_top=1,
                             pad_bottom=1):
    return _conv3x3_fake(x, w, b, relu_out, with_stats, pad_top, pad_bottom)


def maxpool2(x):
    return cuda_pool.maxpool2_forward(x)


def _maxpool2_fake(x):
    n, h, w, c = x.shape
    return x.new_empty((n, -(-h // 2), -(-w // 2), c))


def conv_i8(x8, w8, stride, pad, v, dtype, sx, y_in, bias, relu, wk, pad_top=None,
            pad_bottom=None):
    return cuda_conv_i8.conv_i8_forward(x8, w8, stride, pad, v, dtype, sx=sx, y_in=y_in,
                                        bias=bias, relu=relu, wk=wk, in_place=False,
                                        pad_top=pad_top, pad_bottom=pad_bottom)


def _conv_i8_fake(x8, w8, stride, pad, v, dtype, sx, y_in, bias, relu, wk, pad_top=None,
                  pad_bottom=None):
    n, h, w, _ = x8.shape
    k, co = w8.shape[0], w8.shape[3]
    size = cuda_conv_i8.out_size
    pad_top, pad_bottom = cuda_conv_i8._pads(pad, pad_top, pad_bottom)
    return x8.new_empty((n, size(h, k, stride, pad_top, pad_bottom), size(w, k, stride, pad), co),
                        dtype=dtype)


def quant_i8(x, sx, up):
    x8, scales = quant.quant_i8_forward(x, sx, None if up is None else tuple(up))
    return x8, (x.new_empty((0,), dtype=torch.float32) if scales is None else scales)


def _quant_i8_fake(x, sx, up):
    n, h, w, c = x.shape
    oh, ow = (h, w) if up is None else up
    return (x.new_empty((n, oh, ow, c), dtype=torch.int8),
            x.new_empty((0 if sx is not None else 2,), dtype=torch.float32))


def _group_members(xs, sxs, ups):
    return [(x, sx, None if not ups[2 * j] else (ups[2 * j], ups[2 * j + 1]))
            for j, (x, sx) in enumerate(zip(xs, sxs))]


def quant_i8_group(xs, sxs, ups):
    x8s, scales = quant.quant_i8_group_forward(_group_members(xs, sxs, ups))
    return x8s, (xs[0].new_empty((2, 0), dtype=torch.float32) if scales is None else scales)


def _quant_i8_group_fake(xs, sxs, ups):
    members = _group_members(xs, sxs, ups)
    return ([x.new_empty((x.shape[0], *(x.shape[1:3] if up is None else up), x.shape[3]),
                         dtype=torch.int8) for x, _, up in members],
            xs[0].new_empty((2, sum(sx is None for sx in sxs)), dtype=torch.float32))


_LIB = torch.library.Library("mgtpu", "DEF")
for _schema, _impl, _fake in (
        ("conv3x3(Tensor x, Tensor w, Tensor b, bool relu_out, bool with_stats,"
         " int pad_top=1, int pad_bottom=1, Tensor? y_in=None) -> (Tensor, Tensor)", conv3x3,
         _conv3x3_fake),
        ("conv3x3_bn_relu_in(Tensor x, Tensor w, Tensor b, Tensor scale, Tensor shift,"
         " bool relu_out, bool with_stats, int pad_top=1, int pad_bottom=1)"
         " -> (Tensor, Tensor)", conv3x3_bn_relu_in,
         _conv3x3_bn_relu_in_fake),
        ("maxpool2(Tensor x) -> Tensor", maxpool2, _maxpool2_fake),
        ("conv_i8(Tensor x8, Tensor w8, int stride, int pad, Tensor? v, ScalarType dtype,"
         " Tensor? sx, Tensor? y_in, Tensor? bias, bool relu, Tensor? wk, int? pad_top=None,"
         " int? pad_bottom=None) -> Tensor", conv_i8,
         _conv_i8_fake),
        ("quant_i8(Tensor x, Tensor? sx, int[]? up) -> (Tensor, Tensor)", quant_i8,
         _quant_i8_fake),
        ("quant_i8_group(Tensor[] xs, Tensor?[] sxs, int[] ups) -> (Tensor[], Tensor)",
         quant_i8_group, _quant_i8_group_fake)):
    _LIB.define(_schema)
    _LIB.impl(_impl.__name__, _impl, "CPU")
    _LIB.impl(_impl.__name__, _impl, "CUDA")
    torch.library.register_fake(f"mgtpu::{_impl.__name__}", _fake, lib=_LIB)
