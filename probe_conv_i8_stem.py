#!/usr/bin/env python3
"""Where the `stem` design of conv_i8 spends its time: the kernel as
committed beside copies of it with one phase taken out, in turns on the
card's clock, at R-MG-34's three 7x7/2 stems (batch 128, bf16 out with
the bias, as the int8 forward launches them).

    python3 probe_conv_i8_stem.py      # on the card, from the repository root

The copies are made from `mgtpu_torch/csrc/conv_i8_stem.cu` by text
substitution and built with nvcc and the flags of `mgtpu_torch.kernels`
into a temporary directory; each prints its registers. A copy computes
a wrong result on purpose; only the committed kernel is checked against
the plain version. The variants:
  no gather    the A registers are the offsets, not the patch's bytes
  no products  no wgmma (the accumulators folded from the A registers)
  no epilogue  no finish and no store of the tile
  skeleton     none of those three, nor the zeroing of the padding: the
               patches' copies, the barriers and the tile arithmetic
A phase's cost is at most the whole kernel's time less its variant's
(the phases overlap).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as c
from mgtpu_torch import kernels
from mgtpu_torch.ops import cuda_conv_i8

SOURCE = kernels.CSRC / "conv_i8_stem.cu"
GATHER = """      a[st][0] = word_at(buf, base[0] + lo);
      a[st][1] = word_at(buf, base[1] + lo);
      a[st][2] = word_at(buf, base[0] + hi);
      a[st][3] = word_at(buf, base[1] + hi);"""
NO_GATHER = """      a[st][0] = base[0] + lo;
      a[st][1] = base[1] + lo;
      a[st][2] = base[0] + hi;
      a[st][3] = base[1] + hi;"""
PRODUCTS = "      wgmma_rs<BN>(acc, a[st], gmma_desc(saddr(ws) + 256 * st, 128, 8 * K, 0));"
NO_PRODUCTS = "      acc[st] += a[st][0] ^ a[st][1] ^ a[st][2] ^ a[st][3];"
EPILOGUE = "    const int rows = max(0, min(16, T.q1 - T.q0 - 16 * warp));"
NO_EPILOGUE = ("    if (T.rows > 0) {  // keep the accumulators alive\n"
               "      if (acc[0] == 0x7fffffff && acc[BN / 2 - 1] == 0x12345) y = nullptr;\n"
               "      continue;\n    }\n" + EPILOGUE)
ZERO = "    zero_outside(T, buf, g, L, warp, lane);"
NO_ZERO = "    if (L.rows < 0) zero_outside(T, buf, g, L, warp, lane);"
VARIANTS = {"no gather": [(GATHER, NO_GATHER)], "no products": [(PRODUCTS, NO_PRODUCTS)],
            "no epilogue": [(EPILOGUE, NO_EPILOGUE)],
            "skeleton": [(GATHER, NO_GATHER), (PRODUCTS, NO_PRODUCTS), (EPILOGUE, NO_EPILOGUE),
                         (ZERO, NO_ZERO)]}
STEMS = [(56, 56, 3, 16, 7, 2, 3, 3, 0, False, True), (112, 112, 3, 32, 7, 2, 3, 3, 0, False, True),
         (224, 224, 3, 64, 7, 2, 3, 3, 0, False, True)]


def build(name: str, edits, tmp: Path) -> ctypes.CDLL:
    """The stem source with ``edits`` (old, new) applied, built alone."""
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer holds {old.strip()[:60]!r}")
        src = src.replace(old, new, 1)
    path = tmp / f"{name.replace(' ', '_')}.cu"
    path.write_text(src)
    so = path.with_suffix(".so")
    done = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", f"-I{kernels.CSRC}",
                           "-o", str(so), str(path)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed ({name}):\n{done.stdout}{done.stderr}")
    regs = sorted({line.split("Used ")[1].split(",")[0] for line in done.stderr.splitlines()
                   if "Used " in line})
    print(f"{name}: built, {', '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.mg_conv_i8_stem.argtypes = list(kernels._SIGNATURES["mg_conv_i8_stem"])
    lib.mg_conv_i8_stem.restype = ctypes.c_int
    return lib


def main() -> None:
    if len(sys.argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    kernels.build()
    libs = {"whole": kernels.library()}
    tmp = Path(tempfile.mkdtemp())
    try:
        with ThreadPoolExecutor(len(VARIANTS)) as ex:
            built = list(ex.map(lambda kv: build(*kv, tmp), VARIANTS.items()))
        libs.update(zip(VARIANTS, built))
        library = kernels.library
        totals = dict.fromkeys(libs, 0.0)
        for i, key in enumerate(STEMS):
            x8, w8, wk, v, sx = c.i8_operands(key, c.TIME_BATCH, seed=900 + i)
            epi = dict(v=v, dtype=torch.bfloat16, sx=sx, bias=torch.zeros(key[3], device="cuda"))
            s, p = key[5], key[6]

            def through(lib):
                def fn():
                    kernels.library = lambda: lib
                    try:
                        return cuda_conv_i8.conv_i8(x8, w8, s, p, wk=wk, **epi)
                    finally:
                        kernels.library = library
                return fn
            fns = {name: through(lib) for name, lib in libs.items()}
            c.check(torch.equal(fns["whole"](), cuda_conv_i8.conv_i8_plain(x8, w8, s, p, **epi)),
                    f"the stem design at {key[:7]} differs from the plain version")
            res = dict(zip(fns, c.device_ms(list(fns.values()), windows=5)))
            for name, (t, _) in res.items():
                totals[name] += t
            print(f"{c.TIME_BATCH}x{key[0]}x{key[1]}x{key[2]}->{key[3]} k7/s2/p3: " + ", ".join(
                f"{name} {t:.4f} ms (spread {sp:.1%})" for name, (t, sp) in res.items()),
                  flush=True)
        print("the three stems: " + ", ".join(f"{name} {t:.4f} ms" for name, t in totals.items()),
              flush=True)
    finally:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
