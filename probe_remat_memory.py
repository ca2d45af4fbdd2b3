#!/usr/bin/env python3
"""Peak memory and time of one training micro-batch under three forwards, on one CUDA card.

    python3 probe_remat_memory.py        # from the repository root; needs one card and nvcc

R-MG-34 in bf16 at batch 128 (the main path's step), seeded weights,
one forward and backward to the parameters' gradients through:

- ``plain``: the model itself, its activations kept for the backward;
- ``whole``: one ``torch.utils.checkpoint`` of the whole forward (the
  shape of JAX's ``jax.checkpoint`` of the whole loss): only the image
  is kept, and the backward runs the forward again before its first
  step;
- ``layers``: `mgtpu_torch.train.step.rematerialized`, the port's
  ``-remat``: one checkpoint segment a top-level layer.

For each, the peak of ``torch.cuda.max_memory_allocated`` over what the
model holds before the call, the peak right after the forward, and the
call's wall time (synchronized), in three rounds (the first warms
cuDNN). Prints the card's name and power limit, then one line a round
and forward.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from chip_smoke import RMG34, TIME_BATCH
from mgtpu_torch import kernels
from mgtpu_torch.models import create_model
from mgtpu_torch.models.base import nll_loss
from mgtpu_torch.train.step import _remat_contexts, rematerialized


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_remat_memory: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    kernels.build()
    kernels.library()
    model = create_model(RMG34, compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0)).cuda().train()
    params = list(model.parameters())
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((TIME_BATCH, 224, 224, 3), generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randint(0, 1000, (TIME_BATCH,), generator=gen, device="cuda")

    def whole(t):
        with set_checkpoint_early_stop(False):
            return checkpoint(model, t, use_reentrant=False,
                              context_fn=lambda: _remat_contexts([], t.device))

    forwards = {"plain": model, "whole": whole, "layers": rematerialized(model)}
    torch.backends.cudnn.deterministic = True  # as the train step asks
    for rnd in range(3):
        for name, fwd in forwards.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = fwd(x)
            after_fwd = torch.cuda.max_memory_allocated() - base
            grads = torch.autograd.grad(nll_loss(out, y), params, allow_unused=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
            print(f"round {rnd} {name}: peak {peak / 2**30:.3f} GiB over the resident "
                  f"model (after the forward {after_fwd / 2**30:.3f} GiB), {ms:.1f} ms",
                  flush=True)
            del out, grads


if __name__ == "__main__":
    main()
