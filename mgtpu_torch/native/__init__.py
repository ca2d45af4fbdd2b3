"""ctypes loader for the native data-plane library (counterpart of
`mgtpu/native/__init__.py`), built from this package's copy of
``mgdata.cpp``.

The library is compiled with g++ at first use, with the JAX loader's
flags (so both compute the same bits), into ``mgtpu_torch/_build/``
under a hash of the source and the flags, and bound with ctypes. Nothing
is built when this module is imported. Unlike the JAX loader, a failed
build raises: there is no quiet fallback to PIL, so a run never measures
a slower data path without saying so.

This module imports neither torch nor jax: process-mode donkeys import
it and must not initialise CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "mgdata.cpp"
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I, _D = ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "mg_resize": [_f32, _I, _I, _I, _f32, _I, _I, _I],
    "mg_warp_affine": [_f32, _I, _I, _I, _f32, _D, _D, _D, _D, _D, _D],
    "mg_crop_flip_normalize": [_f32, _I, _I, _I, _f32, _I, _I, _I, _I, _f32, _f32],
    "mg_whiten": [_f32, _f32, _f32, _f32, _I, _I],
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmgdata_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile to a temporary name, then rename: a killed or concurrent
    build never leaves a partial library under the final name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC} ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.mg_version.restype = ctypes.c_int
            if lib.mg_version() != 1:
                raise RuntimeError(f"{so}: mg_version {lib.mg_version()}, expected 1")
            for name, argtypes in _SIGNATURES.items():
                getattr(lib, name).argtypes = argtypes
            _lib = lib
        return _lib


_FILTERS = {"nearest": 0, "bilinear": 1, "bicubic": 2}


def resize(img: np.ndarray, oh: int, ow: int, filter: str = "bicubic") -> np.ndarray:
    """PIL-parity separable resample; img HWC float32."""
    lib = library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.float32)
    lib.mg_resize(img, h, w, c, out, oh, ow, _FILTERS[filter])
    return out


def warp_affine(img: np.ndarray, coeffs) -> np.ndarray:
    """PIL Image.transform(AFFINE, bilinear) parity; coeffs (a,b,tx,d,e,ty)."""
    lib = library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    out = np.empty_like(img)
    a, b, tx, d, e, ty = (float(v) for v in coeffs)
    lib.mg_warp_affine(img, h, w, c, out, a, b, tx, d, e, ty)
    return out


def crop_flip_normalize(img: np.ndarray, y1: int, x1: int, size: int, flip: bool,
                        mean: np.ndarray, std: np.ndarray,
                        out: np.ndarray | None = None) -> np.ndarray:
    """Fused crop+flip+normalize, optionally into a preallocated slot."""
    lib = library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    if not (0 <= y1 and 0 <= x1 and y1 + size <= h and x1 + size <= w):
        raise ValueError(f"crop ({y1},{x1})+{size} exceeds image {h}x{w}")
    if out is None:
        out = np.empty((size, size, c), np.float32)
    elif out.shape != (size, size, c) or out.dtype != np.float32:
        # ndpointer checks dtype/contiguity only — a wrong-shaped out
        # would let the native write run past the buffer
        raise ValueError(f"out must be ({size},{size},{c}) f32, got {out.shape} {out.dtype}")
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    lib.mg_crop_flip_normalize(img, h, w, c, out, y1, x1, size, int(flip), mean, std)
    return out


def whiten(x: np.ndarray, mean: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(x - mean) @ p for (n, d) x, dense (d, d) p."""
    lib = library()
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    out = np.empty_like(x)
    lib.mg_whiten(x, np.ascontiguousarray(mean, np.float32),
                  np.ascontiguousarray(p, np.float32), out, n, d)
    return out
