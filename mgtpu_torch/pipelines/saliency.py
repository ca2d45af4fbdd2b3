"""Saliency pipeline (counterpart of `mgtpu/pipelines/saliency.py`, the
rebuild of the reference's `pipelines/saliency/{pipeline,test}.lua`).

For each test sample the loader expands one image into a stack of 1 +
841 occluded variants (`dataset/mnist-saliency`), and the stacks of
``-saliencyBatch`` samples go through the net in one forward.
`interest_point` picks 7 probe regions of the un-occluded output (its
centre and 6 points on the edges of its bounding box, `test.lua:51-117`);
the saliency map of probe j sums mask_i * impact_ij over the variants
whose impact, max |out_i - out_0| over the probe, is at least 0.1
(`:146-157`). The results go to testOutput.h5, groups
id%05d/{points,saliency,input,output} (`:163-168`).

Three paths, as in the JAX package:

- ``-saliencyDumpStack 1`` (the default): the loader builds each stack on
  the host, the whole output stack comes back to the host, the probe runs
  there (`interest_point`, `saliency_map`, numpy) and ``output`` is
  written too;
- ``-saliencyDumpStack 0`` with a loader that expands on the device
  (``expand == "device"``, the mnist-saliency loader in that mode): only
  the normalized base image goes to the device, the stack is built there
  by the affine map of `GroupStep`, and the probe runs there
  (`interest_points`, `saliency_maps`, torch, batched over the group);
- ``-saliencyDumpStack 0`` with a loader that expands on the host: the
  stack goes to the device and the probe runs there.

A group of k samples, the last one padded to k, is one forward (the
model's eval-mode forwards of different images are independent, so the
group size does not change a value). Group g + 1 is dispatched before
group g is consumed: its copies and kernels are queued on the device
while the host writes group g (no host sync in between).

With several data-parallel ranks (``sess.mesh``) a group's rows (its k
base images, or its k x 842 host-built variants) are split over the
ranks where they divide, as the JAX pipeline shards them over its data
mesh; each rank runs the forward on its rows, the outputs are gathered
on every rank before the probe, and rank 0 alone writes the h5. Under
-spatial or -tensor the groups are split over the data ranks only, as
the JAX pipeline shards only the batch (`mgtpu/pipelines/saliency.py`):
the ranks of a model group run the same rows whole.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from mgtpu_torch import trace
from mgtpu_torch.parallel import fetch_global, is_primary, shard_batch
from mgtpu_torch.utils import h5


def interest_point(output: np.ndarray, th: float = 0.4, dp: int = 1) -> Optional[np.ndarray]:
    """output: (H, W, 1). Returns (7, H, W, 1) binary probe masks or
    None when the thresholded output has no extent."""
    assert output.ndim == 3 and output.shape[-1] == 1
    o = output[:, :, 0]
    h, w = o.shape
    col_max = o.max(axis=0) >= th  # per column
    row_max = o.max(axis=1) >= th  # per row
    if col_max.sum() < 2 or row_max.sum() < 2:
        return None
    cols = np.flatnonzero(col_max)
    rows = np.flatnonzero(row_max)
    col_st, col_ed = int(cols[0]), int(cols[-1])
    row_st, row_ed = int(rows[0]), int(rows[-1])

    def clamp(p, size):
        # keep the 2dp+1 window inside the image (`saliency/test.lua:90-94`)
        if p - dp < 0:
            p = dp
        if p + dp >= size:
            p = size - dp - 1
        return p

    points = np.zeros((7, h, w, 1), np.float32)
    x = clamp((col_st + col_ed) // 2, w)
    y = clamp((row_st + row_ed) // 2, h)
    points[0, y - dp : y + dp + 1, x - dp : x + dp + 1, 0] = 1
    k = 1
    for ix in range(2):
        x = clamp(col_st + ix * (col_ed - col_st), w)
        for iy in range(3):
            y = clamp(row_st + int(math.ceil((row_ed - row_st) * iy / 2)), h)
            points[k, y - dp : y + dp + 1, x - dp : x + dp + 1, 0] = 1
            k += 1
    return points


def saliency_map(outputs: np.ndarray, points: np.ndarray, mask: np.ndarray,
                 threshold: float = 0.1) -> np.ndarray:
    """outputs: (1+N, H, W, C); points: (7, H, W, 1); mask: (N, H, W, 1).
    Vectorized version of the reference's accumulation loop."""
    ori = outputs[0]
    diff = np.abs(outputs[1:] - ori[None])  # (N, H, W, C)
    n = diff.shape[0]
    p = points.shape[0]
    # (N, P): max over pixels/channels of diff * point mask. The probe
    # masks are small (2dp+1)^2 boxes, so each mask's bounding box is
    # sliced instead of broadcasting an (N, P, H*W, C) product: the same
    # result, since diff >= 0 and the mask is 0 outside the box
    impact = np.zeros((n, p), np.float32)
    for j in range(p):
        ys, xs = np.nonzero(points[j, :, :, 0])
        if ys.size == 0:
            continue
        sub = (diff[:, ys.min():ys.max() + 1, xs.min():xs.max() + 1]
               * points[j, ys.min():ys.max() + 1, xs.min():xs.max() + 1])
        impact[:, j] = sub.reshape(n, -1).max(1)
    keep = (impact >= threshold).astype(np.float32) * impact  # (N, P)
    sal = np.einsum("np,nhwk->phwk", keep, mask)
    return sal.astype(np.float32)


def interest_points(outputs: torch.Tensor, th: float = 0.4, dp: int = 1):
    """`interest_point` on the device for a group: outputs (k, H, W,
    C>=1), each sample's un-occluded output -> (valid (k,) bool, (k, 7,
    H, W, 1) f32 probe masks), the JAX package's ``_interest_point_jnp``
    batched over k. The masks are the host version's, bit for bit;
    ``valid`` False stands for its None (an all-False row or column
    gives argmax 0, as in JAX)."""
    o = outputs[..., 0].float()
    _, h, w = o.shape
    col_ok = (o.amax(dim=1) >= th).to(torch.int32)  # (k, W); argmax takes no bool on CUDA
    row_ok = (o.amax(dim=2) >= th).to(torch.int32)  # (k, H)
    valid = (col_ok.sum(1) >= 2) & (row_ok.sum(1) >= 2)
    col_st = col_ok.argmax(1)  # the first maximum: the first column over th
    col_ed = w - 1 - col_ok.flip(1).argmax(1)
    row_st = row_ok.argmax(1)
    row_ed = h - 1 - row_ok.flip(1).argmax(1)

    def clamp(p, size):
        p = torch.where(p - dp < 0, dp, p)
        return torch.where(p + dp >= size, size - dp - 1, p)

    pts = [(clamp((row_st + row_ed) // 2, h), clamp((col_st + col_ed) // 2, w))]
    for ix in range(2):
        x = clamp(col_st + ix * (col_ed - col_st), w)
        for iy in range(3):
            y = clamp(row_st + torch.ceil((row_ed - row_st) * iy / 2.0).to(row_st.dtype), h)
            pts.append((y, x))
    ys = torch.stack([y for y, _ in pts], 1)[:, :, None, None]  # (k, 7, 1, 1)
    xs = torch.stack([x for _, x in pts], 1)[:, :, None, None]
    ii = torch.arange(h, device=o.device)[:, None]
    jj = torch.arange(w, device=o.device)[None, :]
    points = ((ii - ys).abs() <= dp) & ((jj - xs).abs() <= dp)
    return valid, points.float()[..., None]


def saliency_maps(outputs: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
                  threshold: float = 0.1) -> torch.Tensor:
    """`saliency_map` on the device for a group, the JAX package's
    ``_saliency_map_jnp`` batched over k: outputs (k, 1+N, H, W, C),
    points (k, P, H, W, 1), mask (N, H, W, K) -> (k, P, H, W, K) f32.
    The impact of a variant on a probe is the max of |out_i - out_0|
    times the probe's 0/1 mask over the whole map, as JAX takes it (the
    same value, any order); the sum over the variants is an f32 product
    (torch's default takes no TF32 for it), one a sample."""
    diff = (outputs[:, 1:] - outputs[:, :1]).abs().float()  # (k, N, H, W, C)
    impact = torch.stack([(diff * points[:, j, None]).amax(dim=(2, 3, 4))
                          for j in range(points.shape[1])], 2)  # (k, N, P)
    keep = torch.where(impact >= threshold, impact, 0.0)
    m = mask.reshape(mask.shape[0], -1).float()
    # one product a sample: the same sums at any group size
    sal = torch.stack([kp.T @ m for kp in keep])  # (k, P, H*W*K)
    return sal.reshape(keep.shape[0], keep.shape[2], *mask.shape[1:])


class GroupStep:
    """The device work of one group of k samples: the stacks (built on
    the device from the base images where the loader expands there), the
    forward, and, with ``-saliencyDumpStack 0``, the probe. ``run``
    consumes it through `saliency_samples`; a caller can drive it alone
    (it launches the forward's kernels and returns device tensors, no
    host sync).

    ``loader`` is the test split's SaliencyDataset (``mask``, ``expand``,
    ``noise``, ``meanstd``). On the device the normalized occluded variant
    is the affine map ((1-m)*img + noise - mean)/std = (1-m)*b + (noise -
    m*mean)/std of the host-normalized base image b, whose constant second
    term is made once here (the JAX pipeline's map, so the h5 ``input``
    is the loader's base image bit for bit).

    ``mesh`` (`mgtpu_torch.parallel.Mesh`, default one rank): the group's
    rows split over its ranks where they divide, the forward's outputs
    gathered on every rank (`parallel.fetch_global`) before the probe;
    each rank gets the whole group's results."""

    def __init__(self, model, loader, k: int, dump_stack: bool, device, mesh=None):
        self.model, self.k, self.dump_stack = model, k, dump_stack
        self.device = torch.device(device)
        mask = loader.mask  # (841, H, W, 1)
        self.n_stack = 1 + mask.shape[0]
        self.expand_dev = not dump_stack and getattr(loader, "expand", "host") == "device"
        rows = k if self.expand_dev else k * self.n_stack
        self.mesh = mesh if mesh is not None and rows % mesh.size == 0 else None
        self.mask = None if dump_stack else torch.from_numpy(mask).to(self.device)
        if self.expand_dev:
            mean = np.asarray(loader.meanstd[0], np.float32)
            std = np.asarray(loader.meanstd[1], np.float32)
            self.offset = torch.from_numpy((loader.noise - mask * mean) / std).to(self.device)
            self.inv = 1.0 - self.mask

    def to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, x):
        """x: the group's k host-built stacks (k, 1+N, H, W, C), or, where
        the stack is built on the device, its k base images (k, H, W, C).
        Returns device tensors: with ``dump_stack`` the outputs (k*(1+N),
        Ho, Wo, Co); else (valid (k,), points (k, 7, Ho, Wo, 1), saliency
        (k, 7, H, W, 1)), and, where the stack is built on the device, the
        base images (k, H, W, C) after them. Spans (`mgtpu_torch.trace`):
        ``group``, its ``input`` (the copy to the device and this rank's
        rows), ``stack`` (the expansion on the device), ``forward`` (with
        the gather of a mesh's outputs) and ``probe``."""
        with trace.span("group"):
            if not self.expand_dev:  # the rows: the variants of the k stacks
                x = x.reshape(-1, *x.shape[2:])
            with trace.span("input"):
                x = self.to_device(x)
                mine = x if self.mesh is None else shard_batch(self.mesh, {"x": x})["x"]
            if self.expand_dev:
                with trace.span("stack"):
                    b = mine[:, None]
                    mine = torch.cat([b, self.inv[None] * b + self.offset[None]], 1)
                    mine = mine.reshape(-1, *mine.shape[2:])
            with trace.span("forward"):
                out = self.model(mine)
                if self.mesh is not None:
                    out = fetch_global(self.mesh, out)
            if self.dump_stack:
                return out
            with trace.span("probe"):
                outs = out.reshape(self.k, self.n_stack, *out.shape[1:])
                valid, points = interest_points(outs[:, 0])
                sal = saliency_maps(outs, points, self.mask)
            return (valid, points, sal, x) if self.expand_dev else (valid, points, sal)


def group_size(opt, n_test: int) -> int:
    """-saliencyBatch, at least 1 and at most the test split."""
    return min(max(int(getattr(opt, "saliencyBatch", 4)), 1), max(n_test, 1))


def saliency_samples(sess, step: Optional[GroupStep] = None) -> Iterator[tuple[int, dict]]:
    """(index, {"points", "saliency", "input"[, "output"]} numpy arrays)
    of each test sample whose output has a confident extent, in order:
    the loader's samples through ``sess.pool`` in groups of
    `group_size`, each group through ``step`` (default: a `GroupStep` of
    ``sess.model`` on ``sess.device`` for ``-saliencyDumpStack``), group g
    + 1 dispatched before group g's results are read."""
    opt = sess.opt
    loader = sess.loaders["test"]
    n_test = loader.size()
    mask = loader.mask
    dump_stack = bool(int(getattr(opt, "saliencyDumpStack", 1)))
    k = group_size(opt, n_test)
    if step is None:
        device = getattr(sess, "device", None)
        if device is None:  # no quiet fall-back to the CPU
            raise ValueError("saliency_samples: the session names no device to run the "
                             "groups on (a Session's -device)")
        step = GroupStep(sess.model, loader, k, dump_stack, device, getattr(sess, "mesh", None))

    def specs():
        for i in range(1, n_test + 1):
            yield ("get", "test", i, i, 1)

    def dispatch(items):
        """items: (index, stack or base image), padded to k: one shape for
        every forward. Returns without waiting for the device."""
        n_valid = len(items)
        items = items + [items[-1]] * (k - n_valid)
        stacks = np.stack([s for _, s in items])
        out = step(stacks)
        # only each sample's un-occluded input is kept for the dump (the
        # device-built path returns it from the device)
        inputs0 = None if step.expand_dev else stacks[:, 0].copy()
        return [i for i, _ in items[:n_valid]], inputs0, out

    def groups():
        buf = []
        for ind, (x, _y) in zip(range(1, n_test + 1), sess.pool.imap_specs(specs())):
            buf.append((ind, x[0]))
            if len(buf) == k:
                yield dispatch(buf)
                buf = []
        if buf:
            yield dispatch(buf)

    def consume(group):
        inds, inputs0, out = group
        if step.dump_stack:  # the host probe from the whole stack
            out_np = out.cpu().numpy()  # (k*842, Ho, Wo, Co)
            outs = out_np.reshape((k, -1) + out_np.shape[1:])
            for j, ind in enumerate(inds):
                points = interest_point(outs[j][0])
                if points is None:  # no confident output extent
                    continue
                yield ind, {"points": points, "saliency": saliency_map(outs[j], points, mask),
                            "input": inputs0[j], "output": outs[j]}
            return
        if step.expand_dev:  # the base images come back from the device
            valid, points_k, sal_k, inputs0 = (t.cpu().numpy() for t in out)
        else:
            valid, points_k, sal_k = (t.cpu().numpy() for t in out)
        for j, ind in enumerate(inds):
            if valid[j]:
                yield ind, {"points": points_k[j], "saliency": sal_k[j], "input": inputs0[j]}

    pending = None
    for group in groups():  # dispatch g+1 before consuming g
        if pending is not None:
            yield from consume(pending)
        pending = group
    if pending is not None:
        yield from consume(pending)


def run(sess) -> None:
    """The saliency pipeline (`saliency/pipeline.lua:1-2`: EPOCH = 1,
    test()): every test sample through `saliency_samples`, each kept one
    written to ``<save>/testOutput.h5`` as group id%05d, by the primary
    rank (the others run the groups with it and write nothing), through
    the port's own HDF5 writer, each sample's arrays on disk as it
    comes."""
    opt = sess.opt
    n_test = sess.loaders["test"].size()
    path = os.path.join(opt.save, "testOutput.h5")
    os.makedirs(opt.save, exist_ok=True)
    print("==> doing epoch on testing data:")
    print("==> online epoch # 1")
    t0 = time.time()
    with h5.File(path, "w") if is_primary() else contextlib.nullcontext() as f:
        for ind, arrays in saliency_samples(sess):
            gid = f"id{ind:05d}"
            print(gid)
            for name, value in arrays.items():
                if f is not None:
                    f.create_dataset(f"{gid}/{name}", data=value)
    dt = time.time() - t0
    print(f"saliency: {n_test} samples in {dt:.2f}s "
          f"({n_test / max(dt, 1e-9):.2f} samples/s, group size {group_size(opt, n_test)})")
    print(f"saliency maps -> {path}")
