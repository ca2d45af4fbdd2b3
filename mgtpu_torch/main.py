"""Entry point of the port (counterpart of `mgtpu/main.py`, the rebuild
of the reference's `main.lua` + `run.lua`); takes the JAX CLI's flags:

    python -m mgtpu_torch.main -netType cifar/nmg -dataset cifar100-whitened \\
        -data synthetic -nLayer 2 -train -test ... [-device cpu] [-nGPU N [-zero1]]

Boot order as `main.lua:36-58`: parse the options (two-stage), seed
Python's, numpy's and torch's generators, make the run dir and write
``opts.json``, build the Session (net, model, SGD state, loaders, donkey
pool, steps), run the pipeline ``-pipeline`` names (the standard one, or
with ``saliency`` the saliency harness as epoch 1, `run.lua:1-33`), and
at the end, also on an error, wait for a pending checkpoint write and
shut the donkey pool down. Runs on ``-device`` (default cuda).

``-nGPU`` N > 1 (after the JAX clamp, `data_ranks`) runs N data-parallel
ranks, one process each (`torch.multiprocessing`, spawned): rank r on
``cuda:r``, or on the CPU under ``-device cpu``; the kernels are built
once before. ``-spatial`` or ``-tensor`` M > 1 makes the mesh a grid of
N data x M model ranks (`model_ranks`; the devices, on the CPU
``-nGPU`` processes, must divide by M and N is at most their number / M),
rank r = i x M + j still on ``cuda:r``. Under ``-multihost`` each of the
P launcher processes (`parallel.init_multihost`) spawns N x M / P ranks,
global rank = process id x N x M / P + local rank. Every rank
takes rank 0's run dir; rank r > 0 writes its ``opts.json``, logs and
standard output under ``proc<r>/`` there, and only rank 0 writes
checkpoints and dumps. An error on any rank ends the run with a non-zero
exit code."""

from __future__ import annotations

import contextlib
import json
import os
import random
import socket
import sys

import numpy as np
import torch


def model_ranks(opt) -> int:
    """The ranks of the mesh's second axis: ``-spatial`` or ``-tensor``
    (the options refuse both at once)."""
    return max(opt.spatial, 1) * max(opt.tensor, 1)


def data_ranks(opt, n_processes: int = 1) -> int:
    """The number of data-parallel ranks, as the JAX Session clamps
    ``-nGPU``: at most the devices there are (the visible cards of all
    ``n_processes`` launchers; on the CPU ``-nGPU`` itself, 0 meaning one
    rank a process) over the second axis's ranks (`model_ranks`, which
    must divide the devices), ``-nGPU`` 0 meaning all of them, then the
    largest divisor of ``-batchSize``. A clamp is printed."""
    n_model = model_ranks(opt)
    if opt.device.startswith("cuda"):
        devices = torch.cuda.device_count() * n_processes
        if devices == 0:
            raise SystemExit(f"-device {opt.device}: torch sees no CUDA device")
        where = f"{devices} CUDA devices"
    else:
        devices = opt.nGPU if opt.nGPU > 0 else n_processes
        where = f"-device {opt.device}"
    if devices % n_model:  # the JAX Session's words
        raise SystemExit(f"-spatial/-tensor {n_model} needs a device count divisible by it "
                         f"(have {devices})")
    avail = devices // n_model
    n = min(opt.nGPU if opt.nGPU > 0 else avail, avail)
    if opt.nGPU > 0 and n != opt.nGPU and n_model == 1:
        print(f"==> nGPU clamped to {n} ({where})")
    requested = n
    # the reference's DataParallelTable scattered uneven chunks
    # (`scripts/cifar/rnmg.sh` runs batch 64 on 3 GPUs); the ranks take
    # equal slices, so clamp to the largest divisor of batchSize
    while opt.batchSize % n:
        n -= 1
    if n != requested:  # the JAX Session's line
        print(f"==> nGPU clamped to {n} (batchSize {opt.batchSize} "
              f"must divide across the data mesh)")
    return n


def run(opt, mesh=None):
    """Seed, make the run dir, build the Session on ``mesh`` (default one
    rank) and run the pipeline; return the Session."""
    from mgtpu_torch.pipelines import saliency, standard
    from mgtpu_torch.utils.checkpoint import join_pending_saves

    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)
    torch.manual_seed(opt.manualSeed)

    os.makedirs(opt.save, exist_ok=True)
    with open(os.path.join(opt.save, "opts.json"), "w") as f:
        json.dump(vars(opt), f, indent=2, default=str)
    print(f"==> run dir: {opt.save}")

    sess = standard.Session(opt, mesh)
    # shut down in finally: an exception mid-run must not leave
    # process-mode donkeys alive
    try:
        if opt.pipeline == "saliency":
            sess.epoch = 1
            saliency.run(sess)
        else:
            standard.run(sess)
    finally:
        try:
            # don't exit under an in-flight checkpoint write; re-raises a
            # background write failure (ENOSPC, ...)
            join_pending_saves()
        finally:
            # a failed write must not skip the pool's teardown
            sess.pool.shutdown()
    return sess


def _rank(local: int, opt, n: int, first: int, init_method: str) -> None:
    """One rank: rank ``first + local`` of the ``n`` data x `model_ranks`
    grid."""
    import torch.distributed as dist

    from mgtpu_torch.parallel import make_mesh

    rank = first + local
    device = torch.device(f"cuda:{local}") if opt.device.startswith("cuda") else torch.device(
        opt.device)
    mesh = make_mesh(n, rank=rank, device=device, init_method=init_method,
                     n_model=model_ranks(opt), model_axis="tensor" if opt.tensor > 1 else "model")
    try:
        # every rank computed its own time-stamped run dir: take rank 0's
        save = [opt.save]
        dist.broadcast_object_list(save, 0)
        opt.save = save[0] if rank == 0 else os.path.join(save[0], f"proc{rank}")
        with contextlib.ExitStack() as stack:
            if rank:
                os.makedirs(opt.save, exist_ok=True)
                log = stack.enter_context(open(os.path.join(opt.save, "stdout.log"), "w",
                                               buffering=1))
                stack.enter_context(contextlib.redirect_stdout(log))
            run(opt, mesh)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on this host, for rank 0 to serve the group at."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    """Run the options ``argv`` (default: the command line) give. Returns
    the Session of a one-rank run, None after several ranks."""
    from mgtpu_torch.utils.opts import parse

    opt = parse(argv)
    n_proc, pid, init_method = 1, 0, None
    if opt.multihost:
        from mgtpu_torch.parallel import init_multihost

        coord, n_proc, pid = init_multihost()
        init_method = f"tcp://{coord}"
    n = data_ranks(opt, n_proc)
    n_model = model_ranks(opt)
    world = n * n_model
    if world == 1 and n_proc == 1:
        return run(opt)
    if world % n_proc:
        raise SystemExit(f"{world} ranks do not divide over {n_proc} -multihost processes")
    per = world // n_proc
    grid = f" x {n_model} {'tensor' if opt.tensor > 1 else 'model'} ranks" if n_model > 1 else ""
    print(f"==> {n} data-parallel ranks{grid}" + (f": process {pid}/{n_proc}, ranks "
                                                  f"{pid * per}..{pid * per + per - 1}"
                                                  if n_proc > 1 else ""), flush=True)
    if opt.device.startswith("cuda"):
        from mgtpu_torch import kernels

        kernels.build()  # once, before the ranks start
    import torch.multiprocessing as mp

    sys.stdout.flush()
    ctx = mp.start_processes(_rank, args=(opt, n, pid * per,
                                          init_method or f"tcp://127.0.0.1:{free_port()}"),
                             nprocs=per, join=False, start_method="spawn")
    while not ctx.join():  # raises, and ends the others, when a rank fails
        pass
    return None


if __name__ == "__main__":
    main()
