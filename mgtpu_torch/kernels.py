"""Build, bind and count the hand-written CUDA kernels.

The sources in ``mgtpu_torch/csrc/*.cu`` are compiled at first use by
``nvcc`` into one shared library with a plain C interface, cached in
``mgtpu_torch/_build/`` under a hash of the sources, the headers they
include (``csrc/*.cuh``) and the flags, and bound with ``ctypes``.
Nothing is built or loaded when this module is imported, so the CPU
tests import it on a machine without ``nvcc``.

A failed build raises. There is no fallback: on a CUDA tensor a wrapper
launches its kernel or raises.

Each launch goes through :func:`launch`, which adds one to that
kernel's count in :data:`LAUNCHES` and, for a kernel with two designs,
to the count of the design it took in :data:`ROUTES`; ``chip_smoke.py``
reads the counts to show that a forward pass or a training step really
ran through the kernels, and through which design.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"conv3x3": 0, "conv3x3_bn_relu_in": 0, "maxpool2": 0,
                            "maxpool2_bwd": 0}
# (kernel, design) -> launches since the last reset_launches(), for the
# kernels with two designs: the convs' (mgtpu_torch/ops/cuda_conv.py::_route)
# and the pool forward's (mgtpu_torch/ops/cuda_pool.py::_route)
ROUTES: dict[tuple[str, str], int] = {
    **{(k, r): 0 for k in ("conv3x3", "conv3x3_bn_relu_in") for r in ("sm90", "tile")},
    **{("maxpool2", r): 0 for r in ("sm90", "simple")}}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes; every function returns cudaGetLastError()
_SIGNATURES = {
    # x, w, b, y, stats, n, h, w, ci, co, w_tap_stride, relu, with_stats,
    # is_bf16, stream
    "mg_conv3x3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I, _P),
    # x, w, b, scale, shift, y, stats, n, h, w, ci, co, w_tap_stride, relu,
    # with_stats, is_bf16, stream
    "mg_conv3x3_bn_relu_in": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I,
                              _P),
    # the sm90 designs of the two: the same arguments
    "mg_conv3x3_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I, _P),
    "mg_conv3x3_bn_relu_in_sm90": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I,
                                   _I, _P),
    # x, y, n, h, w, c, is_bf16, stream
    "mg_maxpool2": (_P, _P, _I, _I, _I, _I, _I, _P),
    # x, y, n, h, w, c, k (row pairs a chunk), grid, stage_limit, is_bf16, stream
    "mg_maxpool2_sm90": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, y, g, dx, n, h, w, c, first_only, is_bf16, stream
    "mg_maxpool2_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTES:
        ROUTES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and headers lives (built
    or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmgtpu_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise if any fails. Returns their
    joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels if no library for these sources exists yet:
    one nvcc per source, all started together, then one link.
    Returns (library path, build seconds, nvcc's output)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(_sources(), objs)])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log += _run_all([[_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                      "-o", str(tmp), *map(str, objs)]])
    secs = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, so)
    return so, secs, log


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(kernel: str, entry: str, device: torch.device, *args, route: str | None = None) -> None:
    """Call C entry ``entry`` with ``device`` current, on its current
    stream; raise on a launch error, and count one launch of ``kernel``
    (and of its design ``route``, for a kernel with two designs)."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()} launch refused or failed)")
    LAUNCHES[kernel] += 1
    if route is not None:
        ROUTES[(kernel, route)] += 1
