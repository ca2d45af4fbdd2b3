"""Standard train/test/eval pipeline (counterpart of
`mgtpu/pipelines/standard.py`, the rebuild of the reference's
`pipelines/standard/{pipeline,train,test,eval}.lua`).

Epoch loop (`pipeline.lua:1-10`): for EPOCH = epochNumber..nEpochs run
train(), eval() every nEpochsEval, test() every nEpochsTest, checkpoint
every nEpochsSave. The batches are the JAX package's, bit for bit: the
same job specs and seeds go to a copy of its donkey pool. The
per-iteration stdout format keeps the reference's `Run:… lr:… Data:…`
shape (`train.lua:184-199`).
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import fields
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from mgtpu_torch import trace
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.parallel import (fetch_global, gather_tree, is_primary, make_mesh, replicate,
                                  shard_batch, shard_opt_zero1, shard_params_tp, whole_tensors)
from mgtpu_torch.utils import h5
from mgtpu_torch.utils.logging import EpochLogger, fmt_metrics, now


def net_opts(opt) -> NetOpts:
    """The NetOpts of the parsed options (the flags that shape the net)."""
    return NetOpts(**{f.name: getattr(opt, f.name) for f in fields(NetOpts)
                      if hasattr(opt, f.name)})


def host_cast_inputs(batch: dict, dtype) -> dict:
    """A numpy batch dict as CPU tensors, its f32 input ('x') cast to
    ``dtype`` on the host (None: kept f32). Under ``-dtype bfloat16
    -hostCast 1`` this halves the bytes copied to the card; the first
    conv casts its input to the compute dtype anyway, so the values on
    the card are unchanged up to pooling before the first conv now
    rounding in bf16 (as in the JAX package's ``host_cast_inputs``, whose
    bits torch's round-to-nearest-even cast reproduces). Targets stay as
    they are: losses and metrics keep full precision."""
    x = torch.from_numpy(np.ascontiguousarray(batch["x"]))
    if dtype is not None and x.dtype == torch.float32:
        x = x.to(dtype)
    return {"x": x, "y": torch.from_numpy(np.ascontiguousarray(batch["y"]))}


def calib_window(i: int, batch_size: int, size: int):
    """1-based inclusive index window(s) of the i-th int8 calibration
    batch of a loader without ``sample``: consecutive disjoint windows,
    wrapping when the split runs out. One or two (lo, hi) segments that
    always hold min(batch_size, size) samples, so every calibration
    forward sees one batch shape (the JAX package's ``calib_window``)."""
    bs = min(batch_size, size)
    start = (i * bs) % size  # 0-based
    if start + bs <= size:
        return [(start + 1, start + bs)]
    return [(start + 1, size), (1, bs - (size - start))]


def calibration_batches(loaders: dict, opt) -> list:
    """``opt.int8Calib`` NHWC f32 batches of ``opt.batchSize`` from the
    first of the train, eval and test splits, as the JAX Session draws
    them: ``sample`` with the generator seeded ``manualSeed * 7919 + 13``
    where the loader has it, else distinct windows (`calib_window`);
    ten-crop stacks flattened to images."""
    src = next(loaders[k] for k in ("train", "eval", "test") if k in loaders)
    rng = np.random.default_rng(opt.manualSeed * 7919 + 13)
    batches = []
    for i in range(opt.int8Calib):
        if hasattr(src, "sample"):
            x, _ = src.sample(opt.batchSize, rng)
        else:
            parts = [src.get(lo, hi)[0] for lo, hi in calib_window(i, opt.batchSize, src.size())]
            x = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if x.ndim > 4:
            x = x.reshape((-1,) + x.shape[-3:])
        batches.append(x)
    return batches


def quantize_session_model(model, loaders: dict, opt) -> None:
    """``-int8``: quantize ``model`` in place (`mgtpu_torch.ops.quant`) and,
    with ``-int8Calib N``, freeze static activation scales over N
    calibration batches; print the JAX Session's lines."""
    from mgtpu_torch.ops.quant import calibrate, quantize_model

    quantize_model(model)
    if opt.int8Calib > 0:
        calibrate(model, calibration_batches(loaders, opt))
        print(f"==> int8: conv kernels quantized; activation "
              f"scales calibrated over {opt.int8Calib} batches (static)")
    else:  # the JAX Session's line word for word, so the two logs compare
        print("==> int8: conv kernels quantized (per-channel "
              "weights, dynamic per-tensor activations, int32 "
              "MXU accumulation)")
        print("WARNING: dynamic activation scales take an absmax reduction of every "
              "conv input before its quantize; add -int8Calib N to freeze static "
              "scales", file=sys.stderr)


class Session:
    """The run's state (the reference's OPT/MODEL/NETOBJ/DONKEYS globals,
    `main.lua:21-27`): the net, its model on ``opt.device`` with its SGD
    state, the loaders, the donkey pool, the steps and the loggers. The
    saliency harness (``mnist-cluttered/mnist-saliency``) builds its
    model from ``-trainedNet``, weights included, in eval mode.

    ``mesh`` (`mgtpu_torch.parallel.make_mesh`; default one rank on
    ``opt.device``): this rank's place in a data-parallel run. The model
    runs on the rank's device as rank 0's replica, batches keep the
    rank's rows (`to_device`), and under ``-zero1`` the momentum keeps
    the rank's slices (after a resume too). With the mesh's second axis:
    under -spatial the batches also keep the rank's part of their height;
    under -tensor the parameters, running stats and momentum keep the
    rank's channel slices (`parallel.shard_params_tp`, after a resume
    from a whole checkpoint too), and checkpoints are written whole."""

    def __init__(self, opt, mesh=None):
        from mgtpu_torch.data import get_loaders
        from mgtpu_torch.data.prefetch import DonkeyPool
        from mgtpu_torch.models import get_spec, net_options
        from mgtpu_torch.train.optim import sgd_init
        from mgtpu_torch.train.step import (make_eval_step, make_tencrop_eval_step,
                                            make_train_step)
        from mgtpu_torch.utils.bridge import load_jax_tree, load_momentum
        from mgtpu_torch.utils.checkpoint import load_checkpoint, model_meta

        self.opt = opt
        self.mesh = mesh if mesh is not None else make_mesh(device=opt.device)
        self.device = self.mesh.device
        self.compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
        self.net = get_spec(opt.netType)
        self.net_opt = net_options(net_opts(opt))
        zero1 = opt.zero1 and self.mesh.size > 1
        second = self.mesh.n_model > 1
        self.spatial = second and self.mesh.axis == "model"
        self.tensor = second and self.mesh.axis == "tensor"
        if opt.zero1 and not zero1:  # the JAX Session's line
            print("==> -zero1 has no effect: the data mesh axis is size 1 "
                  "(nGPU 1, or batchSize clamped it) — momentum stays "
                  "replicated and optimizer memory is NOT sharded")
        model = self.net.create_model(self.net_opt, compute_dtype=self.compute_dtype,
                                      generator=torch.Generator().manual_seed(opt.manualSeed))
        self.loss_fn = self.net.create_loss(self.net_opt)
        momentum = None
        if opt.retrain != "none":
            ckpt = load_checkpoint(opt.retrain)
            load_jax_tree(model, ckpt["params"], ckpt["stats"])
            momentum = ckpt["opt_state"]
            print(f"=> resumed from {opt.retrain} (epoch {ckpt['epoch']})")
        self.model = replicate(self.mesh, model.to(self.device))
        self.opt_state = (load_momentum(self.model, momentum) if momentum is not None
                          else sgd_init(self.model.parameters()))
        if zero1:
            self.opt_state = shard_opt_zero1(self.mesh, self.opt_state, self.model.parameters())
        if self.tensor:
            self.opt_state = shard_params_tp(self.mesh, self.model, self.opt_state)
        self.loaders = get_loaders(opt)
        if opt.int8:  # after the resume, before the steps (opts refuses -train)
            quantize_session_model(self.model, self.loaders, opt)
        self.meta = model_meta(opt)
        self.pool = DonkeyPool(opt.nDonkeys, mode=opt.donkeyMode, opt=opt, loaders=self.loaders)
        self.epoch = opt.epochNumber

        # bucketing concatenates the momentum leaves, which under -zero1
        # and -tensor are slices: off there, as in JAX
        self.train_step = make_train_step(self.model, self.loss_fn, self.net,
                                          iter_size=opt.iterSize, momentum=opt.momentum,
                                          remat=opt.remat,
                                          bucket_sgd=not (zero1 or self.tensor),
                                          log_grad_norm=opt.logGradNorm, mesh=self.mesh,
                                          zero1=zero1)
        mk_eval = make_tencrop_eval_step if opt.tenCrop else make_eval_step
        self.test_step = mk_eval(self.model, self.loss_fn, self.net, "test", self.mesh)
        self.eval_step = mk_eval(self.model, self.loss_fn, self.net, "eval", self.mesh)
        # int8 quantizes the raw input, with no compute-dtype cast: a host
        # cast would round the images the scales were calibrated without
        self.cast_dtype = self.compute_dtype if opt.hostCast and not opt.int8 else None
        self._loggers: Dict[str, EpochLogger] = {}

    def to_device(self, batch: dict, batch_axis: int = 0) -> dict:
        """This rank's rows of a numpy batch (along ``batch_axis``: 1 for
        an ``iterSize`` batch; under -spatial, and of their height too)
        on the device: cast on the host
        (``-hostCast``), then copied from pinned memory without blocking
        the host."""
        batch = host_cast_inputs(shard_batch(self.mesh, batch, batch_axis, spatial=self.spatial),
                                 self.cast_dtype)
        if self.device.type != "cuda":
            return batch
        return {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in batch.items()}

    def logger(self, name: str) -> EpochLogger:
        if name not in self._loggers:
            self._loggers[name] = EpochLogger(os.path.join(self.opt.save, f"{name}.log"))
        return self._loggers[name]

    def lr_wd(self):
        opt = self.opt
        if opt.LR != 0.0:  # manual override (`train.lua:25-31`)
            return {"lr": opt.LR, "wd": opt.weightDecay}
        return self.net.train_rule(self.epoch, self.net_opt)


def _acc_update(acc: Dict[str, tuple], metrics: Dict[str, float], n: int):
    for k, v in metrics.items():
        s, c = acc.get(k, (0.0, 0))
        acc[k] = (s + float(v) * n, c + n)


def _acc_mean(acc) -> Dict[str, float]:
    return {k: s / max(c, 1) for k, (s, c) in acc.items()}


def _start_profile(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    trace.drain()  # spans of earlier profiles
    prof.start()
    return prof


def _stop_profile(prof: torch.profiler.profile, out_dir: str) -> None:
    """``out_dir``/trace.json, the profiler's, and spans.json, the
    program's spans recorded while it ran (`mgtpu_torch.trace`), on its
    clock."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
    trace.write_chrome(os.path.join(out_dir, "spans.json"), trace.drain(), base_ns)
    print(f"profiler trace -> {out_dir}")


def train(sess: Session):
    opt = sess.opt
    rule = sess.lr_wd()
    lr, wd = rule["lr"], rule["wd"]
    print("==> doing epoch on training data:")
    print(f"==> online epoch # {sess.epoch}")
    if opt.resetMomentum:
        # the reference rebuilt optimState each epoch, dropping momentum
        # (`pipelines/standard/train.lua:48-55`): opt-in reproduction
        from mgtpu_torch.train.optim import reset_momentum

        sess.opt_state = reset_momentum(sess.opt_state)

    seed0 = opt.manualSeed * 1_000_003 + sess.epoch * opt.epochSize * opt.iterSize

    def specs():
        for it in range(opt.epochSize):
            yield ("gen", "train", opt.batchSize, sess.epoch, seed0 + it * opt.iterSize,
                   opt.iterSize)

    # -profile DIR traces iterations 2..9 (1 builds and warms up) of the
    # first epoch only
    prof_dir = opt.profile if sess.epoch == opt.epochNumber else ""
    prof = None

    acc: Dict[str, tuple] = {}
    t_epoch = time.time()
    t_data = time.time()
    n = opt.batchSize * opt.iterSize

    # Metrics are synced ONE iteration late: reading a metric value blocks
    # the host on the device step, which would serialize dispatch with
    # compute. Holding iteration i's (device-resident) metrics while
    # dispatching i+1 keeps the device busy back to back; the
    # per-iteration line is printed one step later with the same content.
    pending = None  # (it, device metrics, dispatch timestamp, data_t)

    def flush(p, overlap=0.0):
        """Run: = this step's dispatch-to-done wall. If reading the
        metrics blocked, the step was still running: the host work since
        dispatch (the next batch's fetch) overlapped it and added nothing,
        so the full elapsed time is the step's. If the read returned at
        once, the step finished during that host work, so the overlap is
        subtracted rather than counted twice against the next line's
        Data:."""
        p_it, p_metrics, p_t0, p_data_t = p
        t_block = time.time()
        vals = {k: float(v) for k, v in p_metrics.items()}  # blocks until the step is done
        t_done = time.time()
        stepped = (t_done - t_block) > 1e-3  # we genuinely waited
        run_t = max(t_done - p_t0 - (0.0 if stepped else overlap), 0.0)
        _acc_update(acc, vals, n)
        print(f"{now()} Epoch: [{sess.epoch}][{p_it + 1}/{opt.epochSize}]\t"
              f"Run:{run_t:.3f}s lr:{lr:.3e} Data:{p_data_t:.3f}s " + fmt_metrics(vals),
              flush=True)

    for it, batch in enumerate(sess.pool.imap_specs(specs())):
        data_t = time.time() - t_data
        if prof_dir and it == 1 and prof is None:
            prof = _start_profile(sess.device)
        batch = sess.to_device(batch, 1 if opt.iterSize > 1 else 0)
        t_run = time.time()
        metrics = sess.train_step(sess.opt_state, batch, lr, wd)
        if pending is not None:
            flush(pending, overlap=data_t)
        pending = (it, metrics, t_run, data_t)
        if prof is not None and it >= 8:
            # flush (= wait for) the just-dispatched step first so the
            # trace holds it whole
            flush(pending)
            pending = None
            _stop_profile(prof, prof_dir)
            prof, prof_dir = None, ""
        t_data = time.time()
    if pending is not None:
        flush(pending)
    if prof is not None:  # epochSize < 9: close the trace at the epoch's end
        _stop_profile(prof, prof_dir)

    means = _acc_mean(acc)
    print(f"Epoch: [{sess.epoch}][TRAINING] Total Time(s): {time.time() - t_epoch:.2f} "
          + fmt_metrics(means, prefix="avg."))
    print()
    sess.logger("train").add({f"avg.{k} (train set)": v for k, v in means.items()})


def _eval_loop(sess: Session, mode: str):
    """Shared body of test() / eval() (`test.lua:19-95`,
    `eval.lua:18-84`). test additionally dumps stored outputs to
    testOutput_<EPOCH>.h5 (`test.lua:63-89`), NHWC as the outputs are."""
    opt = sess.opt
    split = "test" if mode == "test" or "eval" not in sess.loaders else "eval"
    if mode == "eval" and split == "test":
        print("WARNING: -eval requested but this dataset provides no eval/val "
              "split; falling back to the TEST split (a second test pass).")
    loader = sess.loaders[split]
    n_total = loader.size()
    if n_total == 0:
        print(f"WARNING: {split} split is empty — skipping {mode}()")
        return {}
    step = sess.test_step if mode == "test" else sess.eval_step
    print(f"==> doing epoch on {mode} data:")
    print(f"==> online epoch # {sess.epoch}")

    def specs():
        i = 1
        while i <= n_total:
            i2 = min(i + opt.batchSize - 1, n_total)
            yield ("get", split, i, i2, sess.epoch)
            i = i2 + 1

    # stored outputs are dumped in test mode only (`test.lua:63-89`), by
    # the primary rank; eval copies no outputs to the host
    collect = mode == "test" and is_primary()
    mesh = sess.mesh
    metrics_fn = sess.net.test_metrics if mode == "test" else sess.net.eval_metrics
    acc: Dict[str, tuple] = {}
    stored: Dict[str, list] = {}
    t0 = time.time()
    for x, y in sess.pool.imap_specs(specs()):
        n = x.shape[0]
        # one rank: the ragged tail runs at its own size, its metrics its
        # samples' own, weighted by their count, as the JAX loop's
        # recomputation on the true slice of its padded batch gives them.
        # Several: the tail is padded to a multiple of the ranks (the last
        # sample repeated) and split; every rank gathers the outputs and
        # takes the metrics of the true n on the global batch, as JAX does
        pad = -n % mesh.size
        if pad:
            x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            y = np.concatenate([y, np.repeat(y[-1:], pad, 0)])
        metrics, out = step(sess.to_device({"x": x, "y": y}))
        if mesh.size > 1:
            out = fetch_global(mesh, out)[:n]
            yt = torch.from_numpy(np.ascontiguousarray(y[:n])).to(out.device)
            metrics = metrics_fn(out, yt, sess.loss_fn(out, yt))
        _acc_update(acc, {k: float(v) for k, v in metrics.items()}, n)
        if collect:
            for k, v in sess.net.stored_outputs(out).items():
                stored.setdefault(k, []).append(v.float().cpu().numpy())

    means = _acc_mean(acc)
    label = "TESTING" if mode == "test" else "EVALUATION"
    print(f"Epoch: [{sess.epoch}][{label}] Total Time(s): {time.time() - t0:.2f} "
          + fmt_metrics(means, prefix="avg."))
    print()
    sess.logger(mode).add({f"avg.{k} ({mode} set)": v for k, v in means.items()})

    if stored:
        path = os.path.join(opt.save, f"testOutput_{sess.epoch}.h5")
        os.makedirs(opt.save, exist_ok=True)
        with h5.File(path, "w") as f:
            for k, chunks in stored.items():
                f.create_dataset(k, data=np.concatenate(chunks, axis=0))
        print(f"stored outputs -> {path}")
    return means


def test(sess: Session):
    return _eval_loop(sess, "test")


def evaluate(sess: Session):
    return _eval_loop(sess, "eval")


def run(sess: Session):
    """Epoch loop (`pipelines/standard/pipeline.lua:1-10`)."""
    from mgtpu_torch.utils.checkpoint import (join_pending_saves, pending_save_failed,
                                              save_checkpoint)

    opt = sess.opt
    for epoch in range(opt.epochNumber, opt.nEpochs + 1):
        sess.epoch = epoch
        if opt.train:
            train(sess)
        if opt.eval and epoch % opt.nEpochsEval == 0:
            evaluate(sess)
        if opt.test and epoch % opt.nEpochsTest == 0:
            test(sess)
        stop_here = opt.stopAfter and epoch >= opt.stopAfter
        # a -stopAfter epoch always checkpoints (resume must not lose work
        # when the stop point is off the -nEpochsSave cadence)
        if opt.train and (epoch % opt.nEpochsSave == 0 or stop_here):
            # gather first, on every rank (a collective): -zero1's momentum
            # slices to whole buffers, so the checkpoint is a one-rank run's
            opt_state = gather_tree(sess.mesh, sess.opt_state, sess.model.parameters())
            if sess.mesh.all_ranks is not None and sess.mesh.size * sess.mesh.n_model > 1:
                # the primary learns of its previous async write's failure
                # only when it joins: tell every rank, so that all stop
                # together instead of the others waiting in the next
                # collective until its timeout
                bad = torch.tensor(int(is_primary() and pending_save_failed()),
                                   device=sess.device)
                dist.all_reduce(bad, group=sess.mesh.all_ranks)
                if int(bad):
                    join_pending_saves()  # re-raises with the cause on the primary
                    raise RuntimeError("primary's async checkpoint write failed; aborting")
            # -tensor: the whole leaves, gathered on every rank (a collective)
            with whole_tensors(sess.mesh, sess.model, opt_state) as whole_state:
                if is_primary():
                    path = os.path.join(opt.save, f"model_{epoch}.ckpt")
                    # async: the copy to the host happens inside the call
                    # (the next step updates the parameters in place); the
                    # npz write overlaps the next epoch. main joins before
                    # the process exits, and load_checkpoint before it reads.
                    save_checkpoint(path, sess.model, whole_state, epoch, sess.meta,
                                    async_write=True)
                    print(f"checkpoint -> {path}")
        if stop_here:
            # bounded partial run: exit after this epoch without touching
            # -nEpochs (which the LR rules read)
            print(f"==> stopping after epoch {epoch} (-stopAfter)")
            break
