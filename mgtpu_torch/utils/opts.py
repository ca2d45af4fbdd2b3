"""Two-stage option parsing (counterpart of `mgtpu/utils/opts.py`, the
rebuild of the reference's `opts.lua`): global flags first, then the
selected net's flags (its NetSpec's ``arguments``, which register them
as ``--flag``; here they take the JAX CLI's single dash), and the run
dir is derived from the non-default flag string + timestamp, so every
run directory is self-describing. The flags, defaults and run-dir string
are the JAX package's; the port adds ``-device``.

A flag whose function the port does not have yet is refused with the
ROADMAP item that ports it (:data:`REFUSED`): none is silently
ignored. ``-int8`` with ``-train`` stops the run as the JAX Session does
(int8 is an inference-only path); ``-int8Calib`` without ``-int8`` is
ignored, as the JAX Session ignores it. The mesh's second axis takes the
JAX Session's refusals in its words (:data:`CLASHES`): ``-spatial`` with
``-tensor``, ``-zero1`` with ``-tensor``, ``-int8`` with ``-tensor``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

# flag -> (is it asked for, given the parsed options; what ports it)
REFUSED = {
    "-allowPickleCkpt": (lambda o: o.allowPickleCkpt,
                         "no item: the port reads mgtpu-ckpt npz archives only and never "
                         "unpickles"),
}
# (do the options clash; the message the run stops with): the JAX
# Session's refusals, in its words
CLASHES = (
    (lambda o: o.spatial > 1 and o.tensor > 1,
     "-spatial and -tensor both shard the second mesh axis; use one or the other"),
    (lambda o: o.zero1 and o.tensor > 1,
     "-zero1 and -tensor are mutually exclusive: tensor parallelism already shards the "
     "momentum 1/N over the 'tensor' axis"),
    (lambda o: o.int8 and o.tensor > 1,
     "-int8 does not compose with -tensor (channel-sharding rules assume float kernel "
     "leaves)"),
)


class _SingleDash:
    """The parser as a NetSpec's ``arguments`` sees it: ``--flag`` names
    are registered as the JAX CLI's ``-flag``."""

    def __init__(self, parser: argparse.ArgumentParser):
        self._parser = parser

    def add_argument(self, *names, **kw):
        return self._parser.add_argument(*(n[1:] if n.startswith("--") else n for n in names),
                                         **kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="mgtpu_torch training script", allow_abbrev=False
    )
    # ------------- General options ---------------------
    p.add_argument("-cache", default="checkpoint/", help="save/log dir root")
    p.add_argument("-data", default="/path/to/dataset/folder", help="dataset folder, or 'synthetic'")
    # ------------- Data options ------------------------
    p.add_argument("-manualSeed", type=int, default=2)
    p.add_argument("-GPU", type=int, default=1, help="kept for CLI parity (unused)")
    p.add_argument("-nGPU", type=int, default=1,
                   help="data-parallel ranks, one process and card each (0 = all the "
                        "cards; with -device cpu, CPU processes), clamped to the cards "
                        "there are and to a divisor of -batchSize; BatchNorm sums over "
                        "the global batch")
    p.add_argument("-nDonkeys", type=int, default=2, help="data loading threads (0 = sync)")
    p.add_argument("-imageSize", type=int, default=256)
    p.add_argument("-imageCrop", type=int, default=224)
    p.add_argument("-colorspace", default="bgr", choices=["gray", "rgb", "bgr"])
    p.add_argument("-dataAug", default="default", help="default | affine | rotate")
    # ------------- Training options --------------------
    p.add_argument("-nEpochs", type=int, default=20)
    p.add_argument("-epochSize", type=int, default=10000, help="iterations per epoch")
    p.add_argument("-epochNumber", type=int, default=1, help="epoch to start from (restarts)")
    p.add_argument("-batchSize", type=int, default=128)
    p.add_argument("-iterSize", type=int, default=1, help="micro-batches per optim step")
    # ------------- Testing/Eval options ----------------
    p.add_argument("-nEpochsTest", type=int, default=1)
    p.add_argument("-nEpochsEval", type=int, default=1)
    p.add_argument("-nEpochsSave", type=int, default=1)
    p.add_argument("-tenCrop", action="store_true",
                   help="10-crop testing for ilsvrc (latent in the reference)")
    # ------------- Optimization options ----------------
    p.add_argument("-LR", type=float, default=0.0, help="overrides the model trainRule if set")
    p.add_argument("-momentum", type=float, default=0.9)
    p.add_argument("-weightDecay", type=float, default=5e-4)
    # ------------- Model options -----------------------
    p.add_argument("-netType", default="alexnet")
    p.add_argument("-dataset", default="ilsvrc")
    p.add_argument("-retrain", default="none", help="checkpoint to resume from")
    p.add_argument("-allowPickleCkpt", action="store_true",
                   help="refused: the port never unpickles")
    # ------------- Run options -------------------------
    p.add_argument("-train", action="store_true")
    p.add_argument("-eval", action="store_true")
    p.add_argument("-test", action="store_true")
    p.add_argument("-pipeline", default="standard",
                   help="standard, or saliency (the occlusion-saliency harness)")
    p.add_argument("-saliencyBatch", type=int, default=4,
                   help="saliency pipeline: occlusion stacks per forward")
    p.add_argument("-saliencyDumpStack", type=int, default=1,
                   help="1 (default): write the full 842-stack output "
                        "per sample to testOutput.h5 like the reference "
                        "(saliency/test.lua:163-168), the probe on the host. "
                        "0: build the stack, probe and saliency on the "
                        "device, dump only {points,saliency,input}")
    # ------------- Additions of the JAX package ---------
    p.add_argument("-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype for conv/matmul")
    p.add_argument("-hostCast", type=int, default=1, choices=[0, 1],
                   help="1 (default): cast input batches to the compute "
                        "dtype on the host before device transfer — "
                        "halves H2D bytes under -dtype bfloat16 (the "
                        "first conv casts its input anyway). 0: transfer "
                        "float32 and cast on device")
    p.add_argument("-synthSize", type=int, default=2000, help="synthetic dataset size")
    p.add_argument("-synthDisjoint", action="store_true",
                   help="synthetic data: perturb each split's class "
                        "prototypes independently so held-out accuracy "
                        "measures generalization, not memorization "
                        "(mgtpu/data/cifar.py)")
    p.add_argument("-resetMomentum", action="store_true",
                   help="zero SGD momentum at each epoch start — the "
                        "reference rebuilt optimState every epoch "
                        "(train.lua:48-55); default keeps momentum "
                        "(documented improvement)")
    p.add_argument("-remat", action="store_true",
                   help="rematerialize activations in the backward pass "
                        "(torch.utils.checkpoint): slower, fits larger batches")
    p.add_argument("-int8", action="store_true",
                   help="post-training int8 inference: per-output-channel int8 conv "
                        "kernels, per-tensor int8 activations, int32 sums on the "
                        "card's int8 tensor cores (mgtpu_torch/ops/quant.py); an "
                        "inference-only path, refused with -train")
    p.add_argument("-int8Calib", type=int, default=0,
                   help="with -int8: freeze static activation scales, the largest "
                        "absmax over N batches drawn from the first of the train, "
                        "eval and test splits (0 = dynamic per-tensor scales, one "
                        "extra reduction per conv input)")
    p.add_argument("-donkeyMode", default="thread", choices=["thread", "process"],
                   help="donkey pool concurrency: threads share loaders "
                        "under the GIL; processes rebuild loaders per "
                        "worker (the reference's per-donkey-state model; "
                        "use for decode-heavy datasets like ilsvrc)")
    p.add_argument("-profile", default="", metavar="DIR",
                   help="capture a torch.profiler trace of train iterations "
                        "2..9 of the first epoch into DIR, as a Chrome "
                        "trace (chrome://tracing, Perfetto), and the "
                        "program's spans on its clock (DIR/spans.json)")
    p.add_argument("-spatial", type=int, default=1,
                   help="spatial parallelism: split the height of every image-shaped "
                        "activation that keeps >= 8 rows a rank over this many ranks of "
                        "the mesh's 'model' axis (halo rows exchanged around each conv "
                        "and pool); coarser scales stay whole. -nGPU counts all ranks")
    p.add_argument("-tensor", type=int, default=1,
                   help="tensor parallelism: split every conv's, BatchNorm's and dense "
                        "layer's output channels (and their momentum) over this many "
                        "ranks of the mesh's 'tensor' axis, where each keeps >= 8; "
                        "-nGPU counts all ranks")
    p.add_argument("-zero1", action="store_true",
                   help="ZeRO-1: shard the SGD momentum over the data-parallel ranks "
                        "(each holds 1/nGPU of every leaf whose trailing dim divides); "
                        "parameters stay whole on every rank")
    p.add_argument("-logGradNorm", action="store_true",
                   help="add per-iteration training diagnostics to the "
                        "metric stream: global grad L2 norm (pre-weight-"
                        "decay), global param L2 norm after the update, "
                        "and the max |param update| of the step — the "
                        "instrumentation for chasing loss spikes / "
                        "effective-LR blowups (opt-in: three extra "
                        "reductions per step)")
    p.add_argument("-synthClasses", type=int, default=1000, help="synthetic ilsvrc classes")
    p.add_argument("-stopAfter", type=int, default=0,
                   help="exit cleanly after this epoch without changing "
                        "-nEpochs (which the LR schedules read): bounded "
                        "partial runs, chained by tools/soak_chain.py "
                        "through -retrain/-epochNumber resume")
    p.add_argument("-multihost", action="store_true",
                   help="one launcher process a host: MGTPU_COORDINATOR (host:port), "
                        "MGTPU_NUM_PROCESSES and MGTPU_PROCESS_ID join them; -nGPU "
                        "counts the ranks of all hosts")
    p.add_argument("-split", type=int, default=0,
                   help="ilsvrc: split a single directory-per-class tree "
                        "N%%/(100-N)%% into train/test (0 = expect "
                        "pre-split train/ + val/ dirs)")
    p.add_argument("-evalSplit", type=int, default=0,
                   help="hold out N samples per class from the TRAIN set "
                        "as a validation split feeding -eval (seeded by "
                        "-manualSeed; classification datasets — the mnist "
                        "tasks carry a real valid split already). 0 keeps "
                        "the reference behavior (-eval falls back to the "
                        "test split with a warning)")
    # ------------- The port's own --------------------
    p.add_argument("-device", default="cuda",
                   help="torch device to run on (cpu runs the kernels' plain "
                        "versions, for tests); not part of the run dir or "
                        "the checkpoint meta")
    return p


def parse(argv: Optional[Sequence[str]] = None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()

    # stage 2: net-contributed flags (opts.lua:56-73)
    net_type = ""
    for i, a in enumerate(argv):
        if a == "-netType" and i + 1 < len(argv):
            net_type = argv[i + 1]
        elif a.startswith("-netType="):  # argparse's '=' form
            net_type = a.split("=", 1)[1]
    if net_type:
        from mgtpu_torch.models import get_spec

        get_spec(net_type).arguments(_SingleDash(parser))

    opt = parser.parse_args(argv)
    if not (opt.train or opt.eval or opt.test):
        parser.error("Must specify at least one running scheme: train, eval or test.")
    for flag, (asked, item) in REFUSED.items():
        if asked(opt):
            raise SystemExit(f"{flag} {getattr(opt, flag[1:])} is not ported yet: {item}")
    for clash, message in CLASHES:
        if clash(opt):
            raise SystemExit(message)
    if opt.int8 and opt.train:  # the JAX Session's check, in its words
        raise SystemExit("-int8 is an inference-only path; drop -train")

    # run dir: cache/<dataset>/<flag-string>/<date> (opts.lua:79-88)
    defaults = {a.dest: a.default for a in parser._actions}
    skip = {"netType", "retrain", "cache", "data", "help", "device"}
    parts = []
    for k in sorted(vars(opt)):
        if k in skip or k not in defaults:
            continue
        v = getattr(opt, k)
        if v != defaults.get(k) and "/" not in str(v):
            parts.append(f"{k}={v}")
    flag_str = ",".join(parts) if parts else "default"
    # dots instead of the reference's ':' (opts.lua:87 os.date); a
    # sub-second suffix keeps same-second launches apart
    stamp = time.strftime("%a%b%d%H.%M.%S%Y").replace(" ", "")
    stamp += f".{int(time.time() * 1e6) % 1_000_000:06d}"
    opt.save = os.path.join(opt.cache, opt.dataset, opt.netType.replace("/", "_"),
                            flag_str, stamp)
    return opt
