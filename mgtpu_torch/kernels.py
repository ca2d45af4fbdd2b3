"""Build, bind and count the hand-written CUDA kernels.

The sources in ``mgtpu_torch/csrc/*.cu`` are compiled at first use by
``nvcc`` into one shared library with a plain C interface, cached in
``mgtpu_torch/_build/`` under a hash of the sources and flags, and bound
with ``ctypes``. Nothing is built or loaded when this module is
imported, so the CPU tests import it on a machine without ``nvcc``.

A failed build raises. There is no fallback: on a CUDA tensor a wrapper
launches its kernel or raises.

Each launch goes through :func:`launch`, which adds one to that
kernel's count in :data:`LAUNCHES`; ``chip_smoke.py`` reads the counts to
show that a forward pass really ran through the kernels.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"conv3x3": 0, "maxpool2": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes; every function returns cudaGetLastError()
_SIGNATURES = {
    # x, w, b, y, stats, n, h, w, ci, co, w_tap_stride, relu, with_stats,
    # is_bf16, stream
    "mg_conv3x3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I, _P),
    # x, y, n, h, w, c, is_bf16, stream
    "mg_maxpool2": (_P, _P, _I, _I, _I, _I, _I, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmgtpu_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels if no library for these sources exists yet.
    Returns (library path, build seconds, nvcc's output)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so, secs, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` with ``device`` current, on its current
    stream; raise on a launch error, and count one launch of ``kernel``."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()} launch refused or failed)")
    LAUNCHES[kernel] += 1
