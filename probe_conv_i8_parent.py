#!/usr/bin/env python3
"""conv_i8's (pad, pad) launch against an earlier build of its kernel, bit
for bit: that per-side H padding left the plain launch as it was.

    git show <commit>:mgtpu_torch/csrc/conv_i8.cu > DIR/conv_i8.cu
    git show <commit>:mgtpu_torch/csrc/sm90_async.cuh > DIR/sm90_async.cuh
    python3 probe_conv_i8_parent.py DIR      # on the card, from the repository root

DIR holds the earlier ``conv_i8.cu`` (the source before its entry points
took ``pad_top`` and ``pad_bottom``) and the header it includes. The
probe builds it with nvcc and the flags of `mgtpu_torch.kernels` into a
temporary directory, binds its two entry points with their earlier
signature, and at every conv_i8 call of R-MG-34's int8 serving forward
(recorded on the CPU: chip_smoke.record_i8) at batch 8, in each epilogue
variant of chip_smoke.I8_VARIANTS, launches the current wrapper (the
design `_route` picks and, where that is sm90, the simple design too)
and the earlier kernel through the same design on the same operands
(through its simple design where it had no such design: the stems).
Prints a line a design, and exits non-zero if any output differs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import torch

import chip_smoke as c
from mgtpu_torch import kernels
from mgtpu_torch.ops import cuda_conv_i8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the entry points before per-side padding: x, w, sx, scale, y_in, bias, y,
# n, h, w, ci, co, k, stride, pad, w_tap_stride, out_kind, relu, stream
EARLIER = (_P,) * 7 + (_I,) * 8 + (_L, _I, _I, _P)


def build(src_dir: Path, out_dir: Path) -> ctypes.CDLL:
    so = out_dir / "libconv_i8_earlier.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(src_dir / "conv_i8.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in ("mg_conv_i8", "mg_conv_i8_sm90"):
        getattr(lib, name).argtypes = list(EARLIER)
        getattr(lib, name).restype = ctypes.c_int
    return lib


def earlier(lib, design, x8, w8, wk, stride, pad, v, dtype, sx, y_in, bias, relu):
    """The earlier kernel's launch, its pointers as the wrapper passes them."""
    n, h, w, ci = x8.shape
    k, co = w8.shape[0], w8.shape[3]
    shape = (n, cuda_conv_i8.out_size(h, k, stride, pad),
             cuda_conv_i8.out_size(w, k, stride, pad), co)
    y = y_in if y_in is not None else torch.empty(shape, dtype=dtype, device=x8.device)
    if design == "sm90":
        ci_total, ofs = cuda_conv_i8._slice(w8)
        w_ptr, tap_stride = wk.data_ptr() + ofs, ci_total
    else:
        w_ptr, tap_stride = w8.data_ptr(), w8.stride(1)
    deq = v is not None
    sx_ptr = (cuda_conv_i8._one(x8.device) if sx is None else sx).data_ptr() if deq else 0
    fn = getattr(lib, "mg_conv_i8" + ("_sm90" if design == "sm90" else ""))
    err = fn(x8.data_ptr(), w_ptr, sx_ptr, v.data_ptr() if deq else 0,
             0 if y_in is None else y_in.data_ptr(), 0 if bias is None else bias.data_ptr(),
             y.data_ptr(), n, h, w, ci, co, k, stride, pad, tap_stride,
             cuda_conv_i8._OUT_KINDS[dtype], int(relu),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"the earlier {design} kernel: CUDA error {err}")
    return y


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    kernels.build()
    shapes = c.record_i8()["ilsvrc/rnmg"]["conv_i8"]
    cases, bad = Counter(), Counter()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(sys.argv[1]), Path(tmp))
        for i, key in enumerate(sorted(shapes)):
            x8, w8, wk, v, sx = c.i8_operands(key, c.CHECK_BATCH, seed=4000 + i)
            stride, pad = key[5], key[6]
            g = torch.Generator(device="cuda").manual_seed(4100 + i)
            bias = torch.randn(w8.shape[3], generator=g, device="cuda")
            y0 = torch.randn(cuda_conv_i8.conv_i8_plain(x8, w8, stride, pad).shape, generator=g,
                             device="cuda")
            route = cuda_conv_i8._route(x8, w8, stride, pad, wk)
            for design in (route, "simple") if route == "sm90" else (route,):
                for dt, ops in c.I8_VARIANTS:
                    kw = {} if dt == torch.int32 else {"v": v, "dtype": dt, "sx": sx}
                    kw.update({"bias": bias} if "bias" in ops else {})
                    kw.update({"relu": True} if "relu" in ops else {})
                    y_in = y0.to(dt) if "y_in" in ops else None
                    if design == route:
                        now = cuda_conv_i8.conv_i8(x8, w8, stride, pad, wk=wk, **kw,
                                                   y_in=None if y_in is None else y_in.clone())
                    else:
                        now = cuda_conv_i8._simple_forward(
                            x8, w8, stride, pad, **kw, y_in=None if y_in is None else y_in.clone())
                    then = earlier(lib, design, x8, w8, wk, stride, pad, kw.get("v"), dt,
                                   kw.get("sx"), None if y_in is None else y_in.clone(),
                                   kw.get("bias"), kw.get("relu", False))
                    torch.cuda.synchronize()
                    cases[design] += 1
                    bad[design] += not torch.equal(now, then)
    for design, n in sorted(cases.items()):
        print(f"conv_i8 {design}: {n} launches at the {len(shapes)} recorded R-MG-34 int8 "
              f"calls (batch {c.CHECK_BATCH}, {len(c.I8_VARIANTS)} epilogue variants), "
              f"{bad[design]} differ from the earlier kernel's", flush=True)
    if sum(bad.values()):
        raise SystemExit("conv_i8 (pad, pad) launches differ from the earlier kernel's")


if __name__ == "__main__":
    main()
