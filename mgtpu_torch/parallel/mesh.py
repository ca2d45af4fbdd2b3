"""Data parallelism over ranks (counterpart of `mgtpu/parallel/mesh.py`).

The JAX package shards one global batch over the 'data' axis of a device
mesh and lets GSPMD insert every reduction: the gradient all-reduce and
BatchNorm's batch moments, which it takes over the global batch. The
port runs one process a rank (a device each, or the CPU), joined in a
``torch.distributed`` process group, and makes those reductions by hand:

  * each rank keeps its rows of the global batch (`shard_batch`);
  * BatchNorm sums its moments over the group while a group is active
    (`mgtpu_torch.nn.batch_group`), so the step is the one-device step
    on the global batch, as in JAX, and not the reference's per-GPU BN;
  * the step all-reduces the gradients once, after its micro-batches
    (`all_reduce_mean`), or under ZeRO-1 reduce-scatters them, updates
    its own slice of each eligible parameter and all-gathers the
    parameters (`reduce_scatter_mean`, `all_gather_slices`);
  * the eval loop gathers the outputs (`fetch_global`), and rank 0
    alone writes checkpoints and dumps (`is_primary`).

A `Mesh` without a group (`make_mesh` with no ``init_method``) is one
rank: every function here is then a passthrough, and the step is the
one-device step bit for bit. A group of one (NCCL on one card) runs the
collectives, which leave every value as it is; BatchNorm sums over a
group of more than one rank only.

The mesh's second axis (``n_model`` > 1, JAX's ``make_mesh(n_data,
n_model, model_axis)``): the ranks form an n_data x n_model grid, rank r
= i * n_model + j at data index i and model index j. Each rank belongs
to its data group (the ranks of its j: the batch's slices; ``group``)
and its model group (the ranks of its i: one batch slice's H-slabs
under -spatial, 'model', or channel slices under -tensor, 'tensor';
``model_group``). `mgtpu_torch.parallel.axis` holds the rules and the
collectives of that axis.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises on every rank (a rank
# that died, or one that took another branch)
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: ``size`` data ranks (the JAX mesh's
    'data' axis), this one's data index ``rank``, running on ``device``;
    ``group`` is the data group (the process group of a data-parallel
    run), None for a group-less single rank. The second axis: ``n_model``
    ranks named ``axis`` ('model' under -spatial, 'tensor' under
    -tensor), this one's index ``model_rank`` in its ``model_group``;
    ``world`` the group of all size x n_model ranks."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    n_model: int = 1
    model_rank: int = 0
    model_group: Optional[dist.ProcessGroup] = None
    axis: str = "model"
    world: Optional[dist.ProcessGroup] = None

    @property
    def all_ranks(self) -> Optional[dist.ProcessGroup]:
        """The group of every rank of the mesh (the data group without a
        second axis)."""
        return self.world if self.world is not None else self.group


def init_multihost() -> tuple[str, int, int]:
    """-multihost: the process group's endpoint from MGTPU_COORDINATOR
    (host:port of process 0, which serves the group's store),
    MGTPU_NUM_PROCESSES and MGTPU_PROCESS_ID, the JAX package's
    variables. torchrun's are MASTER_ADDR:MASTER_PORT, NNODES and
    NODE_RANK, one launcher process a host; set these three from them.
    Returns (coordinator, number of processes, this process's id)."""
    try:
        coord = os.environ["MGTPU_COORDINATOR"]
        n_proc = int(os.environ["MGTPU_NUM_PROCESSES"])
        pid = int(os.environ["MGTPU_PROCESS_ID"])
    except KeyError as e:
        raise SystemExit(f"-multihost needs MGTPU_COORDINATOR, MGTPU_NUM_PROCESSES and "
                         f"MGTPU_PROCESS_ID in the environment ({e.args[0]} is not set)")
    if not 0 <= pid < n_proc:
        raise SystemExit(f"MGTPU_PROCESS_ID {pid} is outside 0..{n_proc - 1}")
    return coord, n_proc, pid


def is_primary() -> bool:
    """True on the rank that writes run artifacts (checkpoints, h5
    dumps): rank 0, or the only one. Parameters are the same bits on
    every rank, so its copy is the run's."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_data: int = 1, rank: int = 0, device="cpu", init_method: Optional[str] = None,
              backend: Optional[str] = None, n_model: int = 1, model_axis: str = "model") -> Mesh:
    """Join the group of ``n_data`` x ``n_model`` ranks as global rank
    ``rank`` and return the rank's `Mesh`: data index rank // n_model,
    model index rank % n_model (JAX's ``devices.reshape(n_data,
    n_model)``), its axis named ``model_axis`` ('model': -spatial,
    'tensor': -tensor). Every rank creates every data and model group,
    in one order. The group is NCCL on a CUDA device and gloo on the CPU
    unless ``backend`` says otherwise (two ranks on one card take gloo:
    NCCL refuses two ranks a device). Without ``init_method`` (a
    ``tcp://host:port`` that rank 0 serves) a single rank joins no group.
    A failed join raises."""
    device = torch.device(device)
    if model_axis not in ("model", "tensor"):
        raise ValueError(f"model_axis {model_axis!r} is not 'model' or 'tensor'")
    if init_method is None:
        if n_data * n_model != 1:
            raise ValueError(f"{n_data} x {n_model} ranks need an init_method to meet at")
        return Mesh(1, 0, device, axis=model_axis)
    if device.type == "cuda":
        if device.index is None or device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: no CUDA device {device} "
                               f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=n_data * n_model,
                            rank=rank, timeout=TIMEOUT)
    if n_model == 1:
        return Mesh(n_data, rank, device, dist.group.WORLD, axis=model_axis)
    i, j = divmod(rank, n_model)
    model_groups = [dist.new_group([a * n_model + b for b in range(n_model)], timeout=TIMEOUT)
                    for a in range(n_data)]
    data_groups = [dist.new_group([a * n_model + b for a in range(n_data)], timeout=TIMEOUT)
                   for b in range(n_model)]
    return Mesh(n_data, i, device, data_groups[j], n_model, j, model_groups[i], model_axis,
                dist.group.WORLD)


def _part(x, axis: int, n: int, i: int, what: str):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"{what}: {size} rows along axis {axis} do not divide over {n} ranks")
    per = size // n
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(i * per, (i + 1) * per)
    return x[tuple(idx)]


def shard_batch(mesh: Mesh, tree: dict, batch_axis: int = 0, spatial: bool = False) -> dict:
    """This rank's rows of a host batch: each entry's ``batch_axis`` (1
    under ``iterSize``, whose batches are (iterSize, B, ...); 0 for plain
    and ten-crop (B, 10, ...) batches) cut into ``mesh.size`` equal
    parts, of which it keeps part ``mesh.rank``. The batch must divide.
    With ``spatial`` (-spatial, a 'model' axis of more than one rank)
    an entry of at least ``batch_axis`` + 4 dims (images, segmentation
    targets; not labels) also keeps its model index's part of its height,
    the third axis from the end (the true H of plain, iterSize and
    ten-crop batches alike), as JAX's ``shard_batch(spatial=True)``."""
    split_h = spatial and mesh.n_model > 1 and mesh.axis == "model"
    if mesh.size == 1 and not split_h:
        return tree
    out = {}
    for k, x in tree.items():
        if mesh.size > 1:
            x = _part(x, batch_axis, mesh.size, mesh.rank, k)
        if split_h and x.ndim >= batch_axis + 4:
            x = _part(x, x.ndim - 3, mesh.n_model, mesh.model_rank, k)
        out[k] = x
    return out


def fetch_global(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (each rank's rows, in rank order) on
    every rank: an all-gather along axis 0. A passthrough without a
    group."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def zero1_spec(t, n_data: int) -> tuple:
    """The JAX package's ZeRO-1 rule for one SGD momentum leaf, as its
    PartitionSpec's entries: the trailing dim (a conv kernel's O, HWIO; a
    BN vector's C) split over 'data' where it divides ``n_data``, with no
    minimum shard size; scalars and leaves that do not divide stay
    replicated, ()."""
    shape = tuple(t.shape)
    if n_data > 1 and len(shape) >= 1 and shape[-1] % n_data == 0:
        return (None,) * (len(shape) - 1) + ("data",)
    return ()


def own_slice(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's trailing-dim slice of ``t`` (a view)."""
    per = t.shape[-1] // mesh.size
    return t[..., mesh.rank * per:(mesh.rank + 1) * per]


def shard_opt_zero1(mesh: Mesh, opt_state: dict, params) -> dict:
    """An SGD state for -zero1: each momentum buffer whose parameter
    `zero1_spec` shards keeps only this rank's trailing-dim slice (1/N of
    its bytes), the others stay whole."""
    return {"m": [own_slice(mesh, m).contiguous() if zero1_spec(p, mesh.size) else m
                  for p, m in zip(params, opt_state["m"], strict=True)]}


def _by_dtype(tensors) -> dict:
    """{dtype: [indices]} in order, for one flat buffer a dtype."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def all_reduce_sum(group, tensors: list, divisors=None) -> None:
    """Replace each tensor by its sum over ``group``, in place, divided by
    its entry of ``divisors`` where given: one all-reduce of one flat
    buffer a dtype."""
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            if divisors is not None and divisors[i] != 1:
                part = part / divisors[i]
            tensors[i].copy_(part.view_as(tensors[i]))


def all_reduce_mean(mesh: Mesh, tensors: list) -> None:
    """Replace each tensor by its mean over the data ranks, in place: one
    all-reduce (a sum, then the division) of one flat buffer a dtype."""
    if mesh.group is None:
        return
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))


def reduce_scatter_mean(mesh: Mesh, tensors: list) -> list:
    """ZeRO-1's gradient reduction: this rank's trailing-dim slice of each
    tensor's mean over the ranks (shape ``(..., c / size)``), from one
    reduce-scatter of one buffer. All tensors share one dtype."""
    if not tensors:
        return []
    n = mesh.size
    # row q of (size, S): rank q's slice of every tensor, one after another
    buf = torch.cat([t.reshape(-1, n, t.shape[-1] // n).transpose(0, 1).reshape(n, -1)
                     for t in tensors], 1).reshape(-1)
    out = torch.empty(buf.numel() // mesh.size, dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter_tensor(out, buf, group=mesh.group)
    out.div_(n)
    shapes = [(*t.shape[:-1], t.shape[-1] // n) for t in tensors]
    return [part.view(s) for part, s in zip(out.split([int(np.prod(s)) for s in shapes]), shapes)]


def all_gather_slices(mesh: Mesh, slices: list, out: list) -> None:
    """The inverse of `reduce_scatter_mean`'s split: every rank's slices
    (each rank passes its own, ``(..., c / size)``) put together into
    the whole tensors ``out`` (``(..., c)``), in place, by one all-gather
    of one buffer. All tensors share one dtype."""
    if not slices:
        return
    flat = torch.cat([s.reshape(-1) for s in slices])
    full = torch.empty(mesh.size * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(full, flat, group=mesh.group)
    rows = full.view(mesh.size, -1).split([s.numel() for s in slices], 1)
    for part, s, t in zip(rows, slices, out):
        n = mesh.size
        t.copy_(part.reshape(n, -1, s.shape[-1]).transpose(0, 1).reshape(t.shape))


def gather_tree(mesh: Mesh, opt_state: dict, params) -> dict:
    """The whole SGD state on every rank (a collective: every rank calls
    it at the same point): -zero1's momentum slices (the buffers narrower
    than their parameters) all-gathered to their parameters' shapes,
    whole buffers as they are. A checkpoint written from it is a one-rank
    run's. Under -tensor, the channel slices (``mg_sliced``) all-gathered
    over the model group to their whole (the parameters themselves:
    `mgtpu_torch.parallel.axis.whole_tensors`)."""
    from mgtpu_torch.parallel import axis

    ms = list(opt_state["m"])
    if mesh.n_model > 1 and mesh.axis == "tensor":
        return {"m": [axis.whole(m, mesh) if axis.sliced(m) else m for m in ms]}
    params = list(params)
    sharded = [i for i, (p, m) in enumerate(zip(params, ms, strict=True)) if m.shape != p.shape]
    if mesh.size == 1 or not sharded:
        return {"m": ms}
    for idx in _by_dtype([ms[i] for i in sharded]).values():
        group = [sharded[i] for i in idx]
        full = [torch.empty_like(params[i], dtype=ms[i].dtype) for i in group]
        all_gather_slices(mesh, [ms[i] for i in group], full)
        for i, t in zip(group, full):
            ms[i] = t
    return {"m": ms}


def same_bits(mesh: Mesh, tensors, group=None) -> bool:
    """True on every rank of ``group`` (default: every rank of the mesh)
    when each holds the same bits in ``tensors`` as the group's first
    rank (a collective)."""
    tensors = list(tensors)
    group = mesh.all_ranks if group is None else group
    if group is None:
        return True
    src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD else 0
    bad = torch.zeros((), dtype=torch.int64, device=mesh.device)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        ref = flat.clone()
        dist.broadcast(ref, src, group=group)
        bad += int(not torch.equal(flat.view(torch.uint8), ref.view(torch.uint8)))
    dist.all_reduce(bad, group=group)
    return int(bad) == 0


def replicate(mesh: Mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Make ``model`` (on ``mesh.device``) rank 0's replica: its
    parameters and buffers broadcast from rank 0 to every rank of the
    mesh (one flat buffer a dtype), then held the same bits on every
    rank, or raise; and each Dropout's masks offset by the data index, so
    that the data ranks drop different elements of their rows (every rank
    built the model from one seed) and the ranks of one model group draw
    the same masks. Returns ``model``."""
    from mgtpu_torch.nn import Dropout

    if mesh.group is None:
        return model
    state = [t.data for t in model.parameters()] + [t for t in model.buffers()]
    for idx in _by_dtype(state).values():
        flat = torch.cat([state[i].reshape(-1) for i in idx])
        dist.broadcast(flat, 0, group=mesh.all_ranks)
        for i, part in zip(idx, flat.split([state[i].numel() for i in idx])):
            state[i].copy_(part.view_as(state[i]))
    if not same_bits(mesh, state):
        raise RuntimeError(f"rank {mesh.rank}: the model differs from rank 0's after the "
                           f"broadcast")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.seed_for_rank(mesh.rank)
    return model


def mean_metrics(mesh: Mesh, metrics: dict) -> dict:
    """Each 0-dim metric averaged over the ranks (one all-reduce), so
    every rank reports the global batch's mean (the metrics are means
    over equal slices)."""
    if mesh.group is None or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, group=mesh.group)
    vals /= mesh.size
    return dict(zip(keys, vals.unbind()))
