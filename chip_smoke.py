#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`mgtpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py           # from the repository root; needs one CUDA card and nvcc
    python3 chip_smoke.py --convs   # the two convs' checks and timings alone (conv_phases)

Builds the port's CUDA kernels from `mgtpu_torch/csrc/`, holds each one
against its plain PyTorch version at the shapes R-MG-34, the six CIFAR
nets, the four cluttered-MNIST nets and PR-MG-30 give it (and the int8
conv at the int8 forwards' shapes), serves a few
requests through `mgtpu_torch.serve.Server` (each of those nets, BN
folded, bf16, seeded random weights), takes a few training steps
through `mgtpu_torch.trainer.Trainer` (the same nets, bf16, SGD), checks that
every path went through the kernels and agrees with the port's plain
CPU path in f32, times the kernels, the serving forward and the
training step with CUDA events, runs two recipes through the run
loop, `mgtpu_torch.main`, and serves R-MG-34, cifar/prnmg and unmg under
int8 (`Server(int8=True)`, `-test -int8`) through the int8 conv and the
activation quantizer kernels, runs the saliency harness (`-pipeline
saliency`), takes the train step's `-remat` steps and a data-parallel
step on two ranks, drives the model tools (`mgtpu_torch.tools`:
model_info, export_model and serve_exported in a fresh process,
bench_serving, bench_step_breakdown), runs R-MG-34's training step
under the mesh's second axis and serves it under int8 across ranks.
Phases:

  1 device   the card, and its name and power limit from nvidia-smi
  2 build    nvcc over mgtpu_torch/csrc/*.cu, bound with ctypes
  3 conv3x3  kernel vs conv3x3_plain at every (H, W, Ci, Co) of the slice,
             batch 8, bf16 and f32, relu_out and with_stats on and off,
             each launch through the design cuda_conv._route picks (sm90:
             TMA + wgmma, for bf16 with Ci, Co multiples of 64; window:
             the rest), and each shape also through the window design
             (where sm90 takes it) and the first design, tile; then (3b)
             with torch.backends.cudnn.allow_tf32 True inside the phase
             alone, conv3x3 and conv3x3_bn_relu_in in f32 through the
             window design's TF32 branch (route window_tf32: Co >= 8) at
             its edge shapes and the saliency forward's shapes at batch
             8, each pad pair at the small ones, vs the plain version on
             operands rounded to TF32 as the kernel rounds them, within
             the bound of summation order over K = 9 * Ci
  4 maxpool2 kernel vs maxpool2_plain, exact, with odd sizes, NaN and -inf,
             each launch through the design cuda_pool._route picks (sm90:
             bulk copies into a ring, 16-byte lanes, for even H and
             16-byte pixels; simple: the rest), and the simple design
             beside it at every shape routed to sm90
  5 serve    batches of 1, 8 and 32 images: shape, finiteness, rows that
             are distributions, exactly 112 conv3x3 and 46 maxpool2
             launches per forward, each conv and pool through the design
             _route predicts from the shapes recorded on the CPU (all 46
             pools sm90); the f32 forward on the card vs the plain
             forward on the CPU
  6 times    each kernel vs its plain version (cuDNN) at batch 128 bf16,
             on the card's clock (queued behind a sleep kernel, so the
             host's launch rate does not set the pace), in turns, with the
             window design (where sm90 takes the shape) and the tile design
             beside the routed one at every shape and cuDNN's one call
             (library), and the sum of the launches routed to window
             (the forward's 42 narrow ones) through window, tile and
             cuDNN; the pool at each shape
             through sm90, simple, its plain version and F.max_pool2d,
             each call on the next of enough copies of its input (over
             100 MB) that it reads from device memory, not the 50 MB L2,
             after a check at batch 128 that sm90 equals the plain
             version; ms, GB/s and share of the bound; each pool
             design's time split by least squares into a fixed cost a
             launch and a rate, beside an empty kernel's; the serving
             forward in images/s at batch 128 bf16, and its time per call
             at batch 1 (these two include the host)
  7 conv3x3_bn_relu_in  kernel vs its plain version at every (H, W, Ci,
             Co) of the training step, batch 8, bf16 and f32, relu_out
             and with_stats on and off, some shifts positive (the halo);
             at the shapes routed to sm90 also with exact zeros in the
             border rows and columns of x; each shape also through the
             window design (where sm90 takes it) and the tile design
  8 maxpool2_bwd  the group design (one launch for a multigrid layer's
             pools) vs maxpool2_bwd_plain member by member, exact, both
             tie rules, at every group the training step forms and at
             edge groups (odd sizes, lane widths 1 and 16 bytes in one
             launch, a member off a 16-byte boundary, MAX_MEMBERS + 1
             members), each member also through the simple design; ties
             at zero and at positive values, NaN, all -inf windows
  9 grads    the conv3x3, conv3x3_bn_relu_in and maxpool2 autograd
             Functions vs autograd of their plain versions, f32, no TF32
 10 train    4 steps of R-MG-34 bf16 at batch 32 on one fixed batch: the
             loss stays finite and falls; exactly 76 conv3x3, 36
             conv3x3_bn_relu_in, 46 maxpool2 and 29 maxpool2_bwd launches
             per step (the 46 pools' backward in 29 groups), the convs,
             pools and pool backwards through the predicted designs;
             one f32 step on the card vs the plain CPU step
 11 times    the training step in images/s at batch 128 bf16; each new
             kernel's summed time per step vs its plain version (and the
             window and tile designs', as in phase 6, and the launches
             routed to window summed); the pool backward at each
             group of the step on rotated inputs as in phase 6, the group
             design beside the simple one summed over the members, the
             plain version and aten's max_pool2d_with_indices_backward
             (indices made outside the timed calls: not quite the same
             function); each backward design's split into a fixed cost a
             launch and a rate, beside an empty kernel's
 12 cifar kernels  the six CIFAR nets (nmg, rnmg, pnmg, prnmg, resnet, vgg)
             at their recipes' depths: their kernel calls recorded on the
             CPU and held to the pinned counts; each kernel vs its plain
             version at every shape they give it (serving at batch 128,
             training at the recipe's micro-batch), the window conv also
             with weight slices off a 16-byte boundary, each shape also
             through the window and tile designs
 13 cifar serve  each net BN-folded bf16 at batch 128: (B, 100) finite
             log-probs that are distributions, the pinned launches per
             forward through the predicted designs; cifar/prnmg's f32
             forward on the card vs the plain CPU forward
 14 cifar train  each net 4 bf16 steps at its recipe's micro-batch and
             iterSize on one batch: the loss falls, the pinned launches
             per step through the predicted designs; cifar/prnmg
             --isDropout one step (its masked parts through conv3x3); one
             f32 step of each net on the card vs the plain CPU step
 15 cifar times  cifar/prnmg's bf16 forward at batch 128 and 1 and its
             64 x 2 step, interleaved on the card's clock (host
             included), the card's busy share of each from a
             torch.profiler trace, and each kernel at prnmg's shapes
             beside its plain version and one PyTorch call
 16 seg route  the cluttered-MNIST nets (unet, unmg, pnmg.mnist,
             prnmg.mnist: 64x64x1 images, per-pixel sigmoids) and
             PR-MG-30 (ilsvrc/prnmgseg, shortcut A) at their recipes:
             their kernel calls recorded on the CPU and held to the
             pinned counts (SEG_PER_FORWARD, SEG_PER_MICRO)
 17 seg kernels  each kernel vs its plain version at every shape they
             give it (and pnmg.mnist's on mnist-seg: Co = 10), at each
             serving batch and the recipe's micro-batch, bf16 and f32,
             the convs also through the window design where sm90 takes
             the shape, and through the tile design
 18 seg serve  each net BN-folded bf16 at its recipe's batch (64; 32 for
             prnmg.mnist; 1 and 128 for PR-MG-30) and PR-MG-52 at batch
             8: probabilities in [0, 1] or log-probs that are
             distributions, the pinned launches per forward through the
             predicted designs; each net's f32 forward on the card vs
             the plain CPU forward
 19 seg train  each net 4 bf16 steps at its recipe's micro-batch and
             iterSize (PR-MG-30's 16 cut to 2) on one batch: the loss
             falls, the pinned launches per step through the predicted
             designs; one f32 step of each net on the card vs the plain
             CPU step
 20 seg times  each net's bf16 serving forward and training step,
             interleaved, with the card's busy share from a profile, and
             each kernel at its shapes beside its plain version and one
             PyTorch call
 21 recipe   the run loop: R-MG-34's recipe (scripts/ilsvrc/rnmg.sh, 64 x
             4 at 224 px, 10 thread donkeys) through mgtpu_torch.main in
             bf16, its epoch cut to 3 iterations and its synthetic set to
             64 images: finite metric lines, exactly 3 x 4 x PER_STEP +
             PER_FORWARD a test batch launches, model_1.ckpt read back
             equal to the live model and momentum; the epoch's img/s and
             Data: share, the data layer's own rate, the card's busy
             share of one profiled step; a second call resumes from the
             checkpoint and runs the ten-crop test pass (PER_FORWARD a
             batch)
 22 harness  unmg's recipe (mnist-seg, 64 a step, f32) through
             mgtpu_torch.main, 3 iterations and the test pass, with its
             pinned launches; then mnist-cluttered/mnist-test -retrain
             on its checkpoint: the same test loss and meanIU within
             1e-5, its pinned launches, and testOutput_1.h5 read back
             through mgtpu_torch.utils.h5 (the port's own HDF5 layer):
             NHWC f32 predictions in [0, 1] of every test sample; then
             python -m mgtpu_torch.tools.seg_metrics on it (mean IU and
             Acc held to utils.metrics' per-class counts) and
             render_predictions (the panel's size)
 23 conv_i8  the int8 conv kernel vs conv_i8_plain at every (shape, k,
             stride, pad, weight slice) the int8 serving forwards of
             R-MG-34 (batches 1 and 128), cifar/prnmg (128) and unmg (64)
             give it, recorded on the CPU and held to the pins
             (I8_PER_FORWARD, I8_ROUTES): through the design
             cuda_conv_i8._route picks (sm90: TMA + wgmma s8 for the 3x3/s1
             parts with channels and offsets multiples of 16; stem: the
             stems on 3 and 1 channels; 1x1: the 1x1 parts on multiples of
             16 channels; simple: the rest) and, where that is not simple,
             through the simple design too; each epilogue variant of
             I8_VARIANTS (int32 sums; f32 and bf16 dequants with the scale
             read on the card; with the part sum, the bias and the ReLU)
             equal bit for bit, full-range int8 operands, the batch-1
             cases also with x off a 16-byte boundary (the design that x
             takes there: stem still, 1x1 and sm90 parts simple);
             then the activation quantizer's group design (one launch a
             multigrid layer) vs quant_i8_group_plain, int8 values and
             scales bit for bit, static and dynamic scales, at every member
             table those forwards give it and at QUANT_EDGE_GROUPS (odd C,
             a 1x1 map upsampled, f32 and bf16 in one launch, misaligned
             members, MAX_MEMBERS + 1 members in two launches), each member
             also through the per-part design (mg_quant_i8)
 24 i8 serve each of those nets served under int8 through Server (BN
             folded, then quantized; bf16) at those batches with static
             scales (I8_CALIB batches) and, R-MG-34, dynamic ones:
             outputs checked, the pinned launches per forward (conv_i8
             once a conv part, quant_i8 once a layer, twice with dynamic
             scales; the pools as in the float forward; no 3x3 conv
             kernel) and conv_i8's pinned designs; a second forward in
             which every quantizer call is held to quantize_act's torch
             ops (and the nearest upsample) on the same activations on
             the card, int8 values and scales equal; the distance from the
             bf16 forward of the same weights (prnmg and unmg: one median
             time of each, int8 and bf16, interleaved); the f32 int8
             forward on the card vs the plain CPU one with the same frozen
             scales (1e-5 of the scale)
 25 i8 run loop  cifar/nmg trained 2 x 4 iterations and tested in f32
             through mgtpu_torch.main, then its checkpoint re-tested
             with -test -int8 -int8Calib 2 and -test -int8: the
             "==> int8:" lines, the test loss within 5% of the float one,
             the unfolded int8 forward's launches per test and
             calibration forward
 26 i8 times R-MG-34's int8 (static and dynamic scales) and bf16
             serving forwards at batch 128 and 1, interleaved (7
             windows), with the card's busy time from a profile (the sum
             of its kernels' device times, beside key_averages' sum, which
             counts a kernel a torch op launched twice)
             and, for the int8 forward at 128, its busy time by kernel
             name (top 10) and its kernels per forward; conv_i8 at each
             shape of the batch-128 int8 forward through its design and
             the simple design, beside its plain version and, a different
             function, the bf16 conv3x3 kernel (3x3/s1 shapes) and cuDNN's
             bf16 conv; its bound at the int8 peak, split by design (sm90,
             stem); the stem and 1x1 parts of cifar/prnmg and unmg at their
             serving batches, in turns: the design, simple, plain, cuDNN's
             bf16 conv and, at the 1x1 parts with int32 out,
             torch._int_mm; quant_i8 at each quantizer group of that forward (a
             layer's parts) through the group design beside the per-part
             design's launches of the same members, its plain torch ops
             and, a different function on f32 copies,
             torch.quantize_per_tensor; its bound at HBM's rate; the host
             us a call of the group wrapper and of the per-part wrappers
 27 saliency the saliency harness: a pnmg.mnist checkpoint
             (scripts/mnist-cluttered/pnmg.mnist.sh's options, seeded,
             BNs calibrated) written by the port; scripts/mnist-cluttered/
             mnist-saliency.sh through the port's Session (8 synthetic
             samples, -saliencyBatch 4: 3,368 images of 64x64x1 a forward,
             f32) at -saliencyDumpStack 1 and 0, through
             saliency.saliency_samples: 50
             conv3x3 and 18 maxpool2 launches a forward through the
             designs predicted at batch 1; samples/s, ms a group, peak
             memory, the card's time by kernel and its idle share; sample
             1's 842 outputs vs the plain CPU forward (phase 18's gate),
             its valid, points and saliency vs the CPU's probe of those,
             the card's probe vs the host's on the same outputs; then
             the recipe through python -m mgtpu_torch.main (saliency.run)
             at both dump modes: its launches, testOutput.h5 read back
             through mgtpu_torch.utils.h5 (exactly the kept samples'
             groups, points and input equal to saliency_samples',
             saliency within its gate, outputs within the forward's), the
             run's samples/s beside saliency_samples', the dump's MB and
             the writer's MB/s alone; render_saliency on the dump-1 file
             (10 PNGs a sample); conv3x3
             and maxpool2 at the forward's shapes at N = 3,368 vs their
             plain versions, then timed beside them and one PyTorch call;
             with allow_tf32 True inside those two steps alone, the TF32
             branch at the same shapes vs the TF32-rounded plain version
             (3b's bound), then the forward's convs timed through it (Co
             = 1: the FMA branch), the FMA branch, cuDNN in TF32 and in
             f32, in turns
 28 remat    the train step's -remat: R-MG-34 bf16 at batch 128 and
             cifar/prnmg --isDropout at 64 x 2, one remat step beside two
             plain ones from the same weights: the update and the running
             stats within three times the plain step's own change between
             its two runs, the forward's kernels launched twice
             (REMAT_PER_STEP), R-MG-34's peak memory lower and both steps
             timed; one f32 remat step of cifar/prnmg vs the CPU's
 29 dp       data parallelism (mgtpu_torch.parallel): cifar/prnmg's recipe
             64 x 2 as 32 x 2 on each of two ranks, spawned processes on
             the one card joined over gloo (NCCL takes one rank a card):
             the f32 step vs the one-rank step on the card (loss within
             1e-5 relative, update and stats within the f32 step gates),
             4 bf16 steps (the loss falls, the same bits on both ranks
             after each, each rank's launches the one-rank pins for its
             micro-batches), each rank's step time and one gradient
             all-reduce's time and bytes (gloo on one card: not NCCL, not
             scaling); the f32 step in an NCCL group of one, bit for bit
             the group-less step; scripts/cifar/prnmg.sh (-nGPU 4) through
             mgtpu_torch.main on one card: the clamp line, one rank
 30 tools    the model tools (mgtpu_torch.tools): model_info's two counts
             for R-MG-34 (the published params and reference MACs, and
             the as-run MACs); the host us a call of four kernels as
             mgtpu:: ops and through their wrappers; R-MG-34 exported at
             batch 128 (BN folded, bf16; and int8 with static scales from
             -calib) through export_model, the program's graph holding
             the mgtpu:: ops; each program served by serve_exported in a
             fresh process that imports no model code: its outputs
             against Server.predict's on the same images (bf16: the same
             top-1 and within 1e-5 of the scale; int8: bit for bit), its
             launches per forward Server.predict's (PER_FORWARD,
             TOOLS_I8_PER_FORWARD), its median of 15 windows alone, then,
             once that process has built the same Server, in turns with
             Server.predict's; the artifact's size; one bench_serving row
             per dtype at batch 128 (bf16, int8-static); and
             bench_step_breakdown at batch 128
 31 axis     the mesh's second axis (mgtpu_torch.parallel.axis): R-MG-34
             at 224 px, two ranks on the one card over gloo (not scaling),
             under -spatial 2 (H-slabs at 224, 112, 56 and 28 rows, whole
             from 14 down) and then under -tensor 2 (channel slices): one
             f32 step at global batch 8 vs the one-rank f32 step on the
             card (loss within 1e-5 relative, update and stats within the
             f32 step gates); AXIS_STEPS bf16 steps at global batch 128
             (phase 10's rate): the loss falls, every leaf the mesh keeps whole the same bits
             on both ranks after each, each rank's launches the one-rank
             pins (PER_STEP) through the designs predicted from the
             recorded shapes (-tensor: the output channels sliced where
             tp_spec says), the convs' halo-mode launches (kernels.PADDED)
             those at the scales split under -spatial; each rank's step
             time, one more step with the axis's collectives (halo and row
             gathers, channel gathers and the inputs' gradient sums)
             counted, their bytes and time; the peak memory of a rank
             against the one-rank bf16 step's
 32 i8 axis  int8 serving across ranks: conv_i8's halo mode at every
             recorded R-MG-34 int8 call whose height spatial_split
             splits (3x3/s1 slabs with pads (1, 0), (0, 1), (0, 0)
             through sm90 and simple; the 7x7/2 stems' (3, 0), (0, 2),
             (0, 0) through stem and simple), each launch bit for bit the whole
             image's at its rows, the whole image's (pad, pad) launches
             bit for bit the plain version; then R-MG-34 served under
             int8 as phase 24 builds it (Server, I8_CALIB batches), at
             global batch 128 through the run loop's eval step, two ranks
             on the one card over gloo (not scaling): under -spatial 2,
             static and dynamic scales, the outputs bit for bit the
             one-rank int8 forward's; under -nGPU 2 (2 x 1), dynamic, each
             rank's rows within 1e-5 of the outputs' scale of the one-rank
             forward's; every dynamic scale bit for bit the one-rank
             forward's and the calibrated ones the same bits on every
             rank; each rank's launches the pins of I8_PER_FORWARD through
             I8_ROUTES' designs, its halo-mode conv_i8 launches
             (kernels.PADDED) those of the split calls, one scale
             all-reduce a layer in a dynamic forward (33), none in a
             static one; a rank's forward
             ms, its scale all-reduces' count and ms, its collectives'
             bytes and ms; rank 0's halo-mode conv_i8 launches of one
             forward timed against their plain version and the whole
             image's launches at the same calls

Any failed check exits non-zero. The second-to-last line of stdout is
one JSON object with the kernels: ``launches`` sums each kernel's
launches over the main-path runs (phase 5's serving forwards, phase
10's training steps, phases 13 and 14's bf16 forwards and steps of
the CIFAR nets, phases 18 and 19's of the others, phases 21 and
22's runs of the CLI, phase 27's saliency runs, phase 28's remat
steps, phase 29's two ranks' bf16 steps and phase 30's: the servers'
builds and calibration, the exported programs' forwards in their own
process (warm-up, counted and timed), that process's servers' builds and
timed Server.predict calls, the forwards that the programs are held to,
bench_serving's and bench_step_breakdown's; phase 31's ranks' bf16
steps under both axes; phase 32's ranks' counted int8 forwards),
``max_abs_err``
is its largest error against its plain version (phases 3, 4, 7, 8, 12,
17), and ``ms`` / ``plain_ms`` /
``library_ms`` are the summed times of its launches (through the design
each takes), of its plain version and of one PyTorch call of the same
function (null where there is none) in one batch-128 bf16 serving
forward (conv3x3, maxpool2) or training step (conv3x3_bn_relu_in,
maxpool2_bwd). ``bound_ms`` is the least time the card could take for
the same launches (:func:`path_bounds`), ``bound_by`` which bound sets
most of it. The two convs name their ``designs`` (launches a pass by
design: sm90 in ``source``, window in ``window_source``) and give
``window_ms`` and ``tile_ms`` (the same launches, each through that
design) and, under ``narrow``, the launches routed to window: their
count a pass and their times through window, tile, the plain version
and cuDNN (null where there is none). ``maxpool2_bwd`` names its
``design`` (group) and gives the simple design's time for the same
pools (``simple_ms``). The two convs give, under ``halo_mode``, rank
0's halo-mode launches of one R-MG-34 step under -spatial 2 at batch
128 (phase 31): their count, time, plain version's time, the
whole-image launches' time at their shapes, one PyTorch call's (conv3x3:
F.conv2d with padding 1 on the slab, its last row dropped), largest
error and bound. Under the key "cifar/prnmg" each kernel has the same
numbers for cifar/prnmg: its launches in phases 13 and 14 (cifar/prnmg's
own), its times and bounds per batch-128 forward or 64 x 2 step (phase
15); under each net of phases 16-20 that launches it, the same numbers
for that net (its launches in phases 18 and 19, its times and bounds per
forward at its largest serving batch or per training step, phase 20);
under "mnist-saliency (...)" conv3x3's and maxpool2's for the saliency
forward (phase 27: its launches, and its times and bounds per 3,368-image
f32 forward, the bound at the f32 peak outside the tensor cores).
The last two entries are ``conv_i8`` and ``quant_i8``: their launches in
phases 24, 25, 30 and 32, their largest error (phase 23 and phase 24's
quantizer checks: 0, the comparisons are exact), their time, their
plain version's and their bound per batch-128 int8 R-MG-34 forward
(phase 26), ``library_ms`` null (no PyTorch call computes an int8 conv
on CUDA, or this quantizer), and for ``conv_i8`` its time by design and
the simple design's at every shape, and, a different function at the
same shapes, the bf16 conv3x3 kernel's and cuDNN's bf16 times, and under
``halo_mode`` rank 0's halo-mode launches of one int8 forward under
-spatial 2 at batch 128 (phase 32), as the two convs give theirs; for
``quant_i8`` torch.quantize_per_tensor's (a different function) and,
under ``designs``, the group design's (the main path's) and the per-part
design's launches per forward, card ms and host ms of their wrappers.
The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mgtpu_torch import kernels
from mgtpu_torch.models import create_model, get_spec
from mgtpu_torch.models.base import NetOpts, imagenet_rule
from mgtpu_torch.ops import cuda_conv, cuda_conv_i8, cuda_pool
from mgtpu_torch.ops.cuda_conv import (bn_relu_plain, conv3x3, conv3x3_bn_relu_in,
                                       conv3x3_bn_relu_in_plain, conv3x3_plain)
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.ops import quant
from mgtpu_torch.ops.quant import quantize_model
from mgtpu_torch.ops.cuda_pool import (maxpool2, maxpool2_backward_group, maxpool2_bwd_plain,
                                       maxpool2_plain)
from mgtpu_torch.ops.resample import nchw
from mgtpu_torch.serve import CALIB_BATCH, Server, image_shape
from mgtpu_torch.train.step import rematerialized
from mgtpu_torch.tools import soak_chain
from mgtpu_torch.trainer import Trainer, synthetic_batch
from mgtpu_torch.utils import h5
from mgtpu_torch.utils.bridge import export_jax_tree

DEPTH = 34
RMG34 = NetOpts(depth=DEPTH)
IMAGE_SHAPE = image_shape(RMG34)
# launches per R-MG-34 serving forward (one per 3x3 same/down part; every
# maxpool2_ceil of the exchange and the MgPools)
PER_FORWARD = {"conv3x3": 112, "conv3x3_bn_relu_in": 0, "maxpool2": 46, "maxpool2_bwd": 0,
               "conv_i8": 0, "quant_i8": 0}
# launches per training step: stage 2's 36 same-scale parts take the
# prologue kernel instead of conv3x3; every pool is differentiated once,
# the pools of one multigrid layer (an exchange's down parts, an MgPool's
# scales) in one grouped launch: 46 pools in 29 launches
PER_STEP = {"conv3x3": 76, "conv3x3_bn_relu_in": 36, "maxpool2": 46, "maxpool2_bwd": 29,
            "conv_i8": 0, "quant_i8": 0}
# launches per training micro-batch with -remat: the forward's kernels
# twice (the first forward, and its run again in the backward), the
# backward's once
REMAT_PER_STEP = {"conv3x3": 152, "conv3x3_bn_relu_in": 72, "maxpool2": 92, "maxpool2_bwd": 29,
                  "conv_i8": 0, "quant_i8": 0}
# the (H, W, C) at which R-MG-34 pools, in either pass
RMG34_POOLS = [(14, 14, 16), (14, 14, 32), (14, 14, 64), (14, 14, 128), (14, 14, 256),
               (28, 28, 32), (28, 28, 64), (28, 28, 128), (56, 56, 64)]
KERNELS = {
    "conv3x3": dict(route="cuda", source="mgtpu_torch/csrc/conv3x3.cu",
                    replaces="mgtpu/ops/pallas_conv.py:220",
                    window_source="mgtpu_torch/csrc/conv3x3_window.cu"),
    "conv3x3_bn_relu_in": dict(route="cuda", source="mgtpu_torch/csrc/conv3x3.cu",
                               replaces="mgtpu/ops/pallas_conv.py:259",
                               window_source="mgtpu_torch/csrc/conv3x3_window.cu"),
    "maxpool2": dict(route="cuda", source="mgtpu_torch/csrc/maxpool2.cu",
                     replaces="mgtpu/ops/pallas_pool.py:63"),
    "maxpool2_bwd": dict(route="cuda", source="mgtpu_torch/csrc/maxpool2.cu",
                         replaces="mgtpu/ops/pallas_pool.py:84",
                         design="group: one launch for a multigrid layer's pools"),
}
CHECK_BATCH, TIME_BATCH = 8, 128
# the H100 SXM's published peaks (NVIDIA's data sheet): dense bf16 on the
# tensor cores and HBM3 bandwidth. Bounds and shares are against these,
# whatever power limit the card runs at (printed beside them).
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
# f32 outside the tensor cores, and f32 operands on the TF32 tensor cores
# (the same data sheet)
PEAK_F32_FLOPS, PEAK_TF32_FLOPS = 67e12, 495e12
# a timed pool call reads its input from device memory only if the other
# inputs it rotates through (more than this in all) have pushed it out of
# the 50 MB L2
COLD_BYTES = 100e6
SERVE_BATCHES = (1, 8, 32)
TRAIN_BATCH, TRAIN_STEPS, F32_STEP_BATCH = 32, 4, 2
# imagenet_rule's second stage (epoch 31): at the epoch-1 rate of 0.1 a
# fixed batch of 32 from a random init overshoots after the first step,
# in the JAX train step as in the port
TRAIN_RULE = imagenet_rule(31)
# f32 step, card vs CPU, same seed and batch: the L2 error of the whole
# parameter update relative to its L2 norm, and the running stats' error
# relative to their scale. Both sides compute in f32 (no TF32) in another
# summation order. One step of this net is sensitive to that: where a
# pre-activation rounds to the other side of a ReLU kink, or a BN's
# one-pass variance cancels, whole gradient terms change. On the CPU the
# same step in f32 against f64 moves the update by 1.6e-3 of its norm
# (4.7% of one tensor's largest change) and the stats by 4e-6; the
# bounds are about six times that and 25 times that.
F32_STEP_PARAM_BOUND, F32_STEP_STATS_BOUND = 1e-2, 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


T0 = time.perf_counter()
# the seconds of the run by phase tag: the time up to each line, summed
# by the tag of the line that ends it
SECONDS: dict = {}
_LAST_LINE = [T0]


def phase(name: str, msg: str) -> None:
    """One line of the run's log, tagged with the phase and the seconds
    since the script started."""
    now = time.perf_counter()
    SECONDS[name] = SECONDS.get(name, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    print(f"[{name} {now - T0:.0f}s] {msg}", flush=True)


def i8_key(x8, w8, stride, pad, *args, y_in=None, bias=None, **kw):
    """A conv_i8 call's recorded shape: (H, W, Ci, Co, k, stride, pad,
    Ci of the whole weight, the slice's first input channel, whether it
    takes a part sum, whether it takes the bias)."""
    k, co = w8.shape[0], w8.shape[3]
    return (*x8.shape[1:], co, k, stride, pad, w8.stride(1) // co, w8.storage_offset() // co,
            y_in is not None, bias is not None)


def quant_key(x, sx=None, up=None):
    """A quantized part's recorded shape: (H, W, C of the input, the
    output's (OH, OW))."""
    return (*x.shape[1:], *(x.shape[1:3] if up is None else up))


def quant_group_keys(members) -> list:
    """The launches of a quant_i8_group call on the card with static
    scales, each as the quant_key of its members, MAX_MEMBERS a launch
    (a layer's parts, or a single conv's input)."""
    keys = [quant_key(*m) for m in members]
    return [tuple(keys[i:i + quant.MAX_MEMBERS]) for i in range(0, len(keys), quant.MAX_MEMBERS)]


def pool_group_keys(xs, ys, gs, *a) -> list:
    """The launches of a maxpool2_backward_group call on the card, each as
    the (H, W, C) of its members: the members with a cotangent and
    elements, MAX_MEMBERS a launch."""
    shapes = [tuple(x.shape[1:]) for x, g in zip(xs, gs) if g is not None and x.numel()]
    return [tuple(shapes[i:i + cuda_pool.MAX_MEMBERS])
            for i in range(0, len(shapes), cuda_pool.MAX_MEMBERS)]


def record_kernel_shapes(train: bool, opt: NetOpts = RMG34, fold: bool = True,
                         int8: bool = False, remat: bool = False):
    """One f32 pass of the net ``opt`` names (R-MG-34 by default) at batch
    1 on the CPU (the plain path), recording the input shapes of every
    kernel entry point it calls: the serving forward (BN folded; with
    ``fold`` False the run loop's eval forward, BN unfolded; with
    ``int8`` quantized after the fold, as Server does), or a training
    forward and backward (one micro-batch; with ``remat`` the train
    step's rematerialized forward, run again in the backward). Returns {kernel: Counter of
    shapes}; a pool backward's shape is its group's: the (H, W, C) of
    each member it launches for, in order (pool_group_keys)."""
    shapes = {k: Counter() for k in PER_STEP}
    one = lambda key: lambda *a, **kw: [key(*a, **kw)]  # noqa: E731
    hooks = {(cuda_conv, "conv3x3_forward"): ("conv3x3", one(lambda x, *a, **kw: (
                 x.shape[1], x.shape[2], x.shape[3], a[0].shape[3]))),
             (cuda_conv, "conv3x3_bn_relu_in_forward"): ("conv3x3_bn_relu_in", one(
                 lambda x, *a, **kw: (x.shape[1], x.shape[2], x.shape[3], a[0].shape[3]))),
             (cuda_pool, "maxpool2_forward"): ("maxpool2", one(lambda x, *a: tuple(x.shape[1:]))),
             (cuda_pool, "maxpool2_backward_group"): ("maxpool2_bwd", pool_group_keys),
             (cuda_conv_i8, "conv_i8"): ("conv_i8", one(i8_key)),
             (quant, "quant_i8_group"): ("quant_i8", quant_group_keys)}
    originals = {key: getattr(*key) for key in hooks}

    def recording(key):
        name, shapes_of = hooks[key]

        def fn(*a, **kw):
            shapes[name].update(shapes_of(*a, **kw))
            return originals[key](*a, **kw)
        return fn

    # the serving forward's net as Server builds it (BN folded), without
    # its calibration: the calls do not depend on the weights
    model = create_model(opt)
    model = model.train() if train else fold_batchnorm(model) if fold else model
    if int8:
        quantize_model(model)
    for key in hooks:
        setattr(*key, recording(key))
    try:
        x = torch.zeros((1, *image_shape(opt)))
        if train:
            (rematerialized(model) if remat else model)(x)[:, 0].sum().backward()
        else:
            with torch.inference_mode():
                model(x)
    finally:
        for key, fn in originals.items():
            setattr(*key, fn)
    return shapes


def predicted_routes(shapes, dtype=torch.bfloat16) -> dict:
    """{(kernel, design): launches} that cuda_conv._route and
    cuda_pool._route give one pass's recorded conv and pool calls in
    ``dtype``: stand-in CPU tensors of their shapes, at batch 1 (the
    routes do not depend on the batch; on the card the
    activations and the weight slices, which start at a multiple of Co
    elements, are 16-byte aligned as they are); the pool backward's
    recorded launches all take the group design."""
    got = dict.fromkeys(kernels.ROUTES, 0)
    for kernel in ("conv3x3", "conv3x3_bn_relu_in"):
        for (h, w, ci, co), count in shapes[kernel].items():
            x = torch.empty((1, h, w, ci), dtype=dtype)
            wt = torch.empty((3, 3, ci, co), dtype=dtype)
            got[(kernel, cuda_conv._route(x, wt))] += count
    for shape, count in shapes["maxpool2"].items():
        got[("maxpool2", cuda_pool._route(torch.empty((1, *shape), dtype=dtype)))] += count
    got[("maxpool2_bwd", "group")] = sum(shapes["maxpool2_bwd"].values())
    return got


def kernel_work(kernel, shape, batch, itemsize=2):
    """(operations, bytes) that one launch of `kernel` at a recorded shape
    must do at `batch`: each input read once, each output written once.
    A conv's operations are its multiply-adds (2 each) on taps inside
    the image: along H, 3H - 2 of the 3H taps (the first and the last
    row each miss one to the zero padding), and as many along W. A pool's
    comparisons are not counted (no peak rate of the card is theirs, and
    they are far below its bytes). A pool backward's shape is a group's:
    the (H, W, C) of each member of one launch."""
    if kernel.startswith("conv3x3"):
        h, w, ci, co = shape
        px = batch * h * w
        # x, w, y in the operand type; the f32 bias (and scale and shift)
        nbytes = itemsize * (px * ci + 9 * ci * co + px * co) + 4 * co
        if kernel == "conv3x3_bn_relu_in":
            nbytes += 8 * ci
        return 2 * batch * (3 * h - 2) * (3 * w - 2) * ci * co, nbytes
    if kernel == "maxpool2_bwd":  # a group: x, y, g in and dx out, for each member
        return 0, sum(2 * itemsize * sum(pool_elements(m, batch)) for m in shape)
    x_el, y_el = pool_elements(shape, batch)
    return 0, itemsize * (x_el + y_el)


def pool_elements(shape, batch):
    """(x's elements, y's) of a pool of (H, W, C) at `batch`"""
    h, w, c = shape
    return batch * h * w * c, batch * -(-h // 2) * -(-w // 2) * c


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take
    for this work (operations at ``peak``: bf16 on the tensor cores by
    default), and which of the two sets it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def path_bounds(shapes, batch, dtype=torch.bfloat16):
    """{kernel: (operations, bytes, bound ms, bound_by)} summed over one
    pass's launches (record_kernel_shapes' counts) at `batch` in
    ``dtype`` (bf16: the tensor cores' peak; f32: the f32 peak outside
    them, which the f32 tile design runs on): the bound of each launch,
    summed; bound_by names the bound that sets most of that sum."""
    out = {}
    itemsize = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    for kernel, counts in shapes.items():
        flops = nbytes = ms = ops_ms = 0
        for shape, count in counts.items():
            f, b = kernel_work(kernel, shape, batch, itemsize)
            t, by = bound(f, b, peak)
            flops, nbytes, ms = flops + count * f, nbytes + count * b, ms + count * t
            ops_ms += count * t * (by == "operations")
        out[kernel] = (flops, nbytes, ms, "operations" if ms and 2 * ops_ms >= ms else "bytes")
    return out


def rotating(fn, sets):
    """A function that calls fn on the next argument tuple of `sets` each
    time, in turn: with sets of more than COLD_BYTES in all, each call
    reads its inputs from device memory, not from the L2 cache."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def cold_copies(tensors):
    """`tensors` and enough copies of them to hold more than COLD_BYTES
    in all: argument tuples for :func:`rotating`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(int(COLD_BYTES // nbytes) + 1)]


def routes_since(before: dict) -> dict:
    return {k: kernels.ROUTES[k] - before[k] for k in kernels.ROUTES}


def routed(kernel, x, wt, fn):
    """fn(), which must launch `kernel` once, through the design _route
    picks for (x, wt)."""
    before = dict(kernels.ROUTES)
    out = fn()
    want = {k: int(k == (kernel, cuda_conv._route(x, wt))) for k in kernels.ROUTES}
    check(routes_since(before) == want, f"{kernel} {tuple(x.shape)}->{wt.shape[3]} {x.dtype}: "
          f"launched {routes_since(before)}, expected {want}")
    return out


def conv_inputs(n, h, w, ci, co, dtype, seed):
    rng = np.random.default_rng(seed)
    if n * h * w * ci >= LARGE:  # drawn on the card
        x = torch.randn((n, h, w, ci), generator=torch.Generator("cuda").manual_seed(seed),
                        device="cuda")
        wt = torch.from_numpy(rng.standard_normal((3, 3, ci, co), dtype=np.float32)
                              / np.sqrt(9 * ci))
        b = torch.from_numpy(0.1 * rng.standard_normal(co, dtype=np.float32))
        return x.to(dtype), wt.cuda().to(dtype), b.cuda()
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((3, 3, ci, co), dtype=np.float32) / np.sqrt(9 * ci))
    b = torch.from_numpy(0.1 * rng.standard_normal(co, dtype=np.float32))
    return x.cuda().to(dtype), wt.cuda().to(dtype), b.cuda()


# inputs of this many elements or more are drawn on the card: the saliency
# forward's reach 0.9 G elements, which numpy takes seconds to draw
LARGE = 2 ** 26


def pool_input(shape, dtype, seed, ties=False):
    if np.prod(shape) >= LARGE and not ties:
        x = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
        x[0, 0, 0, 0] = float("nan")
        x[0, -1, -1, -1] = float("inf")
        x[-1, :2, :2, :] = float("-inf")
        x[-1, -1, -1, -1] = float("nan")
        return x.to(dtype)
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    if ties:  # ReLU outputs on a coarse grid: ties at zero and at positive values
        x = np.maximum(np.round(x * 2) / 2, 0)
    x[0, 0, 0, 0] = np.nan
    x[0, -1, -1, -1] = np.inf
    x[-1, :2, :2, :] = -np.inf  # a window of -inf only
    x[-1, -1, -1, -1] = np.nan  # in a clipped edge window when H or W is odd
    return torch.from_numpy(x).cuda().to(dtype)


def misaligned(t):
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary"""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = next(i for i in range(1, 16) if (flat.data_ptr() + i * t.element_size()) % 16 == 4)
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def pool_equal(y, y_ref):
    """(equal, largest abs difference): NaN equals NaN"""
    same = (y == y_ref) | (torch.isnan(y) & torch.isnan(y_ref))
    err = torch.where(same, 0.0, (y.float() - y_ref.float()).abs().nan_to_num(float("inf")))
    return bool(same.all()) and y.shape == y_ref.shape, err.max().item()


def designed(kernel, design, fn):
    """fn(), which must launch `kernel` once, through `design` (the
    window or the tile design, whose own forwards take any shape)."""
    before = dict(kernels.ROUTES)
    out = fn()
    want = {k: int(k == (kernel, design)) for k in kernels.ROUTES}
    check(routes_since(before) == want, f"{kernel}: launched {routes_since(before)} through "
          f"_{design}_forward, expected {want}")
    return out


DESIGN_FORWARDS = {"window": cuda_conv._window_forward, "tile": cuda_conv._tile_forward}


def conv_designs(x, wt):
    """The designs a check or a timing takes a conv shape through: the
    routed one, the window design where sm90 is routed, and tile."""
    route = cuda_conv._route(x, wt)
    return ["routed"] + (["window"] if route == "sm90" else []) + ["tile"]


def pooled(x, design):
    """maxpool2's forward on x, which must launch once, through `design`:
    maxpool2 where that is the design cuda_pool._route picks, else the
    simple design's own entry."""
    before = dict(kernels.ROUTES)
    y = maxpool2(x) if design == cuda_pool._route(x) else cuda_pool._simple_forward(x)
    want = {k: int(k == ("maxpool2", design)) for k in kernels.ROUTES}
    check(routes_since(before) == want, f"maxpool2 {tuple(x.shape)} {x.dtype}: launched "
          f"{routes_since(before)}, expected {want}")
    return y


# odd H (simple), odd W (sm90 at 8x9x64), a last chunk of fewer row pairs
# (280 pairs at 40x14x14x16: 3 a chunk on 132 SMs), a row pair wider than
# a stage (4x300x64: simple)
POOL_EDGE_SHAPES = [(2, 7, 9, 3), (3, 15, 14, 130), (1, 1, 1, 4), (2, 57, 55, 64), (2, 8, 9, 64),
                    (40, 14, 14, 16), (1, 4, 300, 64)]


def check_conv(cases, max_err, what="", slices=False) -> None:
    """3: conv3x3 vs plain at each ((H, W, Ci, Co), batch). Reference: the
    plain version in f32 on the same (bf16-rounded) inputs. f32 differs
    by summation order only; bf16 adds one rounding of the f32
    accumulator to bf16, up to 2^-8 relative (8 significant bits), so
    its bound is twice that. Stats sum N*H*W values with atomics in a
    varying order. Each shape goes through its routed design, through
    the window design where sm90 is routed, and through the tile design
    (conv_designs). With ``slices``, each shape routed to the window
    design is also taken with its weight a slice of a wider one at input
    channel 3, whose start is off a 16-byte boundary for most Co (the
    exchange passes such slices). Each routed launch is also made with a
    running part sum ``y_in`` (seeded, y's shape; the eval forward's
    exchange sums so), held to the plain version with that y_in at the
    same bounds, and counted once in kernels.SUMMED at its design (a
    launch without it not at all)."""
    n_cases, n_slices, n_design, n_summed = 0, 0, Counter(), Counter()
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}  # largest error / its bound
    for k, ((h, w, ci, co), batch) in enumerate(sorted(cases)):
        for dtype in (torch.bfloat16, torch.float32):
            x, wt, b = conv_inputs(batch, h, w, ci, co, dtype, seed=k)
            y_in = torch.randn((batch, h, w, co), device="cuda",
                               generator=torch.Generator("cuda").manual_seed(k)).to(dtype)
            weights = [wt]
            if slices and cuda_conv._route(x, wt) == "window":
                wide = torch.cat([torch.randn((3, 3, 3, co), device="cuda").to(dtype), wt], dim=2)
                weights.append(wide[:, :, 3:])
            for wi, relu_out, with_stats, yi in itertools.product(
                    weights, (False, True), (False, True), (None, y_in)):
                y_ref, st_ref = conv3x3_plain(x.float(), wi.float(), b, relu_out=relu_out,
                                              with_stats=with_stats,
                                              y_in=None if yi is None else yi.float())
                scale = y_ref.abs().max().item()
                route = cuda_conv._route(x, wi)
                for design in conv_designs(x, wi) if yi is None else ["routed"]:
                    kw = dict(relu_out=relu_out, with_stats=with_stats)
                    summed = dict(kernels.SUMMED)
                    if design == "routed":
                        y, st = routed("conv3x3", x, wi, lambda: conv3x3(x, wi, b, y_in=yi, **kw))
                    else:
                        y, st = designed("conv3x3", design, lambda: DESIGN_FORWARDS[design](
                            x, wi, b, **kw))
                    torch.cuda.synchronize()
                    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
                    err = (y.float() - y_ref).abs()
                    share = (err / (rtol * y_ref.abs() + 1e-5 * scale)).max().item()
                    what_ = (f"conv3x3 {batch}x{h}x{w}x{ci}->{co} {dtype} relu={relu_out} "
                             f"stats={with_stats} w slice={wi is not wt} y_in={yi is not None} "
                             f"{design}")
                    got = {r: n - summed[r] for r, n in kernels.SUMMED.items()}
                    want = {r: int(yi is not None and r == ("conv3x3", route)) for r in got}
                    check(got == want, f"{what_}: SUMMED counted {got}, expected {want}")
                    n_summed[route] += yi is not None
                    check(y.dtype == dtype and share <= 1.0,
                          f"{what_}: max abs err {err.max().item():.3g} (scale {scale:.3g})")
                    worst[dtype] = max(worst[dtype], share)
                    if with_stats:
                        st_err = (st - st_ref).abs()
                        st_tol = 1e-4 * st_ref.abs() + 1e-5 * st_ref.abs().max()
                        check(bool((st_err <= st_tol).all()),
                              f"{what_}: stats max abs err {st_err.max().item():.3g}")
                    else:
                        check(not st.any(), f"{what_}: stats not zero")
                    max_err["conv3x3"] = max(max_err["conv3x3"], err.max().item())
                    n_cases += 1
                    n_slices += wi is not wt
                    n_design[design] += 1
    phase("conv3x3", f"{what}{n_cases} cases at {len(cases)} shapes and batches ({n_slices} with a "
          f"weight slice; {n_design['routed']} through the routed design, {n_design['window']} "
          f"through window at shapes routed to sm90, {n_design['tile']} through tile; "
          f"{sum(n_summed.values())} of the routed with a part sum y_in, by design "
          f"{dict(n_summed)}, each counted in SUMMED): match the plain version (max abs err "
          f"{max_err['conv3x3']:.3g}; largest error {worst[torch.bfloat16]:.2f} of its bound in "
          f"bf16, {worst[torch.float32]:.2f} in f32)")


@contextlib.contextmanager
def tf32_convs(on):
    """``torch.backends.cudnn.allow_tf32`` set to ``on`` inside: PyTorch's
    switch for its f32 convs, which the port's f32 conv3x3 launches
    follow too (cuda_conv._route: window_tf32 where it is True)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


# the TF32 branch's edges: packed K (Ci 1, 3, 5), dense Ci off a multiple
# of 8 (12, 20), Co off a multiple of 8 (10, 20, 70, 130: three channel
# slices), several window chunks (Ci 96, 200), two or more images a tile
# (5x5, 7x7), row and column tails (19x21, 9x13); Ci 10, which TMA does
# not take, stays on the FMA branch
TF32_EDGE_CASES = [((19, 21, 5, 10), 3), ((7, 7, 3, 16), 4), ((9, 13, 12, 20), 2),
                   ((14, 14, 20, 70), 3), ((8, 8, 200, 130), 2), ((28, 28, 96, 64), 2),
                   ((5, 5, 64, 8), 5), ((16, 16, 1, 16), 2), ((9, 13, 10, 20), 2)]


def check_conv_tf32(cases, what="", chunk=256) -> float:
    """3b: conv3x3 and conv3x3_bn_relu_in in f32 under allow_tf32 True
    (tf32_convs) at each ((H, W, Ci, Co), batch). A launch with Co >= 8
    (and Ci < 8 or a multiple of 4) must take the window design's TF32
    branch, and is held to the plain
    version on its operands rounded to TF32 as the kernel rounds them
    (cuda_conv.tf32_round; the prologue's output rounded, as the kernel
    rounds its window after the prologue), computed in float64 (``chunk``
    images at a time; cuDNN's f32 may pick Winograd or FFT algorithms,
    which are no sums of the products), so that the order of the kernel's
    f32 sums is all that differs: two TF32 values multiply exactly in
    f32, an output sums K = 9 * Ci products and the bias, and each of
    the K + 1 additions is off by at most 2^-23 (one unit in the last
    place, rounded or truncated) of the sum of the terms' magnitudes.
    The bound is (K + 1) * 2^-22 * (|x| conv |w| + |b|) on the rounded
    operands, twice that; the stats' bound is that summed over the
    pixels (for the squares, times 2|y| + the bound) plus check_conv's
    1e-4 for the atomics' order. Co < 8 (and Ci >= 8 off a multiple of 4)
    stays on the FMA branch, held to the unrounded plain version at
    check_conv's f32 tolerance. Each case
    with and without ReLU and stats, the small ones also under each pad
    pair; conv3x3 also with a running part sum ``y_in`` (seeded, y's
    shape), one more term of the sum and of the bound, and counted once
    in kernels.SUMMED; with the flag False the same operands must route
    to window. Returns the largest error as a share of its bound."""
    n_cases, worst, n_route, n_summed = 0, 0.0, Counter(), 0
    for k, ((h, w, ci, co), batch) in enumerate(sorted(cases)):
        x, wt, b = conv_inputs(batch, h, w, ci, co, torch.float32, seed=1100 + k)
        with tf32_convs(False):
            check(cuda_conv._route(x, wt) == "window", f"conv3x3 f32 {ci}->{co}: allow_tf32 "
                  f"False routes to {cuda_conv._route(x, wt)}, not window")
        with tf32_convs(True):
            route = cuda_conv._route(x, wt)
        tf32 = co >= 8 and (ci < 8 or ci % 4 == 0)
        check(route == ("window_tf32" if tf32 else "window"), f"conv3x3 f32 {ci}->{co}: "
              f"allow_tf32 True routes to {route}")
        tc = route == "window_tf32"
        wr = (cuda_conv.tf32_round(wt) if tc else wt).double()
        pad_pairs = [(1, 1)] + ([(0, 1), (1, 0), (0, 0)] if batch * h * w <= 4096 else [])
        for prologue in (False, True):
            vec = bn_inputs(ci, seed=1200 + k) if prologue else ()
            kname = "conv3x3_bn_relu_in" if prologue else "conv3x3"
            fn = conv3x3_bn_relu_in if prologue else conv3x3
            for pads, (relu_out, with_stats), summing in itertools.product(
                    pad_pairs, ((False, True), (True, True), (True, False)),
                    (False,) if prologue else (False, True)):
                kw = dict(pad_top=pads[0], pad_bottom=pads[1])
                yi, extra = None, {}  # the running part sum, y's shape
                if summing:
                    yi = torch.randn((batch, cuda_conv.out_rows(x, *pads), w, co), device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(1250 + k))
                    extra = dict(y_in=yi)
                summed = dict(kernels.SUMMED)
                with tf32_convs(True):
                    y, st = routed(kname, x, wt, lambda: fn(
                        x, wt, b, *vec, relu_out=relu_out, with_stats=with_stats, **kw, **extra))
                torch.cuda.synchronize()
                got = {r: n - summed[r] for r, n in kernels.SUMMED.items()}
                check(got == {r: int(summing and r == ("conv3x3", route)) for r in got},
                      f"{kname} {ci}->{co} y_in={summing}: SUMMED counted {got}")
                n_summed += summing
                share, st_ref, slack = 0.0, 0.0, 0.0
                for i in range(0, batch, chunk):
                    xin = x[i:i + chunk]
                    xin = bn_relu_plain(xin, *vec) if prologue else xin
                    xr = (cuda_conv.tf32_round(xin) if tc else xin).double()
                    yd = None if yi is None else yi[i:i + chunk].double()
                    y_ref = conv3x3_plain(xr, wr, b.double(), relu_out=relu_out,
                                          with_stats=False, y_in=yd, **kw)[0]
                    if tc:  # a part sum is one more term
                        mag = conv3x3_plain(xr.abs(), wr.abs(), b.double().abs(), with_stats=False,
                                            y_in=None if yd is None else yd.abs(), **kw)[0]
                        tol = (9 * ci + 1 + summing) * 2.0 ** -22 * mag
                    else:
                        tol = 1e-5 * y_ref.abs() + 1e-5 * y_ref.abs().max()
                    err = (y[i:i + chunk].double() - y_ref).abs()
                    share = max(share, (err / tol.clamp_min(1e-300)).max().item())
                    px = (0, 1, 2)  # every axis but the channels
                    st_ref = st_ref + torch.stack([y_ref.sum(dim=px),
                                                   (y_ref * y_ref).sum(dim=px)])
                    slack = slack + torch.stack([tol.sum(dim=px),
                                                 ((2 * y_ref.abs() + tol) * tol).sum(dim=px)])
                    del xin, xr, yd, y_ref, tol, err
                what_ = (f"{kname} {batch}x{h}x{w}x{ci}->{co} f32 under allow_tf32 ({route}) "
                         f"pads={pads} relu={relu_out} stats={with_stats} y_in={summing}")
                check(y.dtype == torch.float32 and share <= 1.0, f"{what_}: {share:.3g} of its "
                      f"bound")
                worst = max(worst, share)
                if with_stats:
                    st_tol = slack + 1e-4 * st_ref.abs() + 1e-5 * st_ref.abs().max()
                    st_err = (st.double() - st_ref).abs()
                    check(bool((st_err <= st_tol).all()),
                          f"{what_}: stats max abs err {st_err.max().item():.3g}")
                else:
                    check(not st.any(), f"{what_}: stats not zero")
                n_cases += 1
                n_route[route] += 1
                del y, st, yi
        del x, wt, b, wr
    torch.cuda.empty_cache()
    phase("conv3x3", f"{what}f32 under allow_tf32: {n_cases} cases at {len(cases)} shapes and "
          f"batches ({dict(n_route)}; {n_summed} conv3x3 with a part sum y_in, counted in "
          f"SUMMED) match the plain version on TF32-rounded operands within (9 Ci + 1) 2^-22 of "
          f"|x| conv |w| + |b|, one more term with y_in (the FMA branch within f32's): largest "
          f"error {worst:.3g} of its bound")
    return worst


def time_tf32(shapes, n_img, seed=1300) -> dict:
    """The saliency forward's conv3x3 launches (``shapes``: (H, W, Ci, Co)
    -> launches a forward) at ``n_img`` images in f32, in turns: routed
    under allow_tf32 True (window_tf32; window at Co = 1), the window
    design's FMA branch, cuDNN's one call in TF32 and in f32; rates in
    kernel_work's operations, shares of the bound at TF32's peak and the
    HBM's. Returns the per-forward sums (ms) by key, with "bound"."""
    tot = defaultdict(float)
    for k, ((h, w, ci, co), count) in enumerate(sorted(shapes.items())):
        x, wt, b = conv_inputs(n_img, h, w, ci, co, torch.float32, seed=seed + k)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def under(on, fn):
            def call():
                with tf32_convs(on):
                    fn()
            return call

        fns = {"routed": under(True, lambda: conv3x3(x, wt, b, with_stats=False)),
               "window": lambda: cuda_conv._window_forward(x, wt, b, with_stats=False),
               "cudnn_tf32": under(True, lambda: F.conv2d(nchw(x), w_lib, b, padding=1)),
               "cudnn_f32": under(False, lambda: F.conv2d(nchw(x), w_lib, b, padding=1))}
        res = dict(zip(fns, device_ms(list(fns.values()), windows=3)))
        flops, nbytes = kernel_work("conv3x3", (h, w, ci, co), n_img, 4)
        bnd, by = bound(flops, nbytes, PEAK_TF32_FLOPS)
        with tf32_convs(True):
            route = cuda_conv._route(x, wt)
        for key, (t, _) in res.items():
            tot[key] += count * t
        tot["bound"] += count * bnd
        phase("times", f"saliency conv3x3 {n_img}x{h}x{w}x{ci}->{co} f32 (x{count}/forward, "
              f"routed {route}; bound at TF32 {bnd:.3f} ms, by {by}): " + ", ".join(
                  f"{key} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, {bnd / t:.1%}, spread "
                  f"{sp:.1%})" for key, (t, sp) in res.items()))
        del x, wt, b, w_lib
    torch.cuda.empty_cache()
    phase("times", f"saliency conv3x3 per {n_img}-image forward in f32 under allow_tf32: routed "
          f"{tot['routed']:.3f} ms ({tot['bound'] / tot['routed']:.1%} of its bound at TF32, "
          f"{tot['bound']:.3f} ms), the FMA branch {tot['window']:.3f} ms, cuDNN TF32 "
          f"{tot['cudnn_tf32']:.3f} ms, cuDNN f32 {tot['cudnn_f32']:.3f} ms")
    return dict(tot)


def check_pool(shapes, max_err, what="") -> None:
    """4: maxpool2 vs maxpool2_plain at each NHWC shape: a max selects one
    input, so exact, NaN included. Each launch through the design _route
    picks; at the shapes routed to sm90 also through the simple design
    and, from a misaligned copy of x, through the route that takes
    (simple)."""
    designs = Counter()
    for k, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            x = pool_input(shape, dtype, seed=k)
            cases = [(x, cuda_pool._route(x))]
            if cases[0][1] == "sm90":
                cases += [(x, "simple"), (misaligned(x), "simple")]
            for xi, design in cases:
                y, y_ref = pooled(xi, design), maxpool2_plain(xi)
                torch.cuda.synchronize()
                same, err = pool_equal(y, y_ref)
                max_err["maxpool2"] = max(max_err["maxpool2"], err)
                check(same, f"maxpool2 {shape} {dtype} {design} (x at {xi.data_ptr() % 16} "
                      f"past 16 bytes): differs from the plain version")
                designs[design] += 1
    phase("maxpool2", f"{what}{sum(designs.values())} cases at {len(shapes)} shapes (bf16 and "
          f"f32; NaN, +-inf; {designs['sm90']} through sm90, {designs['simple']} through "
          f"simple): equal to the plain version")


def bn_inputs(ci, seed):
    """A BN scale and shift; about three shifts in four are positive, so
    a kernel that normalized its zero halo would be caught."""
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, ci).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0.3, 0.5, ci).astype(np.float32))
    return scale.cuda(), shift.cuda()


def rel_share(got, ref, rtol):
    """Largest error as a share of its bound rtol*|ref| + 1e-5*max|ref|."""
    err = (got.float() - ref.float()).abs()
    return (err / (rtol * ref.float().abs() + 1e-5 * ref.float().abs().max())).max().item()


def device_ms(fns, windows=5):
    """Median and relative spread (max - min over median) of each
    function's per-call time on the card, timed in turns: each window
    times every function once, in an order that rotates from window to
    window. A window's back-to-back calls (enough to fill ~5 ms) are
    queued behind a sleep kernel that outlasts the host's enqueueing of
    them, so the CUDA events time the card, not the host's launch rate
    (which sets the pace of back-to-back calls of a short kernel).
    Returns [(median, spread)] in the order of fns."""
    reps, host_s = [], []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps.append(max(1, min(50, int(0.005 / max(time.perf_counter() - t0, 1e-6)))))
        t0 = time.perf_counter()
        for _ in range(reps[-1]):
            fn()
        host_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    per = [[] for _ in fns]
    for i in range(windows):
        for j in [(i + k) % len(fns) for k in range(len(fns))]:
            # ~2e9 cycles a second at the H100's boost clock; longer at a lower one
            torch.cuda._sleep(int(2e9 * (2 * host_s[j] + 1e-3)))
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps[j]):
                fns[j]()
            b.record()
            b.synchronize()
            per[j].append(a.elapsed_time(b) / reps[j])
    return [(statistics.median(p), (max(p) - min(p)) / statistics.median(p)) for p in per]


def conv_fns(x, wt, b, vec=()):
    """The calls timed at one conv shape (vec: the prologue's scale and
    shift): the routed design, the window design where sm90 is routed,
    the tile design, the plain version and, for conv3x3, cuDNN's one call
    (library); the first key names the routed design."""
    fn, plain = (conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain) if vec else (conv3x3, conv3x3_plain)
    fns = {cuda_conv._route(x, wt): lambda: fn(x, wt, b, *vec, with_stats=False)}
    for design in conv_designs(x, wt)[1:]:
        fns[design] = (lambda d=design: DESIGN_FORWARDS[d](x, wt, b, *vec, with_stats=False))
    fns["plain"] = lambda: plain(x, wt, b, *vec, with_stats=False)
    if not vec:
        w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(x.dtype)
        fns["library"] = lambda: F.conv2d(nchw(x), w_lib, b_lib, padding=1)
    return fns


def time_conv(kname, shape, count, unit, fns, ms, plain_ms, alt, library_ms,
              batch=TIME_BATCH, windows=5) -> None:
    """Times of one conv shape at ``batch``, in turns (conv_fns: the
    routed design, the window design where sm90 is routed, the tile
    design, the plain version, cuDNN's one call where there is one), with
    their rates in the operations kernel_work counts. Adds count x each
    to the per-forward (or per-step) sums: ``ms`` (routed), ``plain_ms``,
    ``library_ms`` by kernel; ``alt[(design, kernel)]`` for window and
    tile; and, where window is the routed design, ``alt[("narrow", name,
    kernel)]`` for each call and ``alt[("narrow", "launches", kernel)]``."""
    flops = kernel_work(kname, shape, batch)[0]
    names = list(fns)
    res = dict(zip(names, device_ms([fns[k] for k in names], windows)))
    route = names[0]
    ms[kname] += count * res[route][0]
    plain_ms[kname] += count * res["plain"][0]
    for design in ("window", "tile"):
        alt[(design, kname)] += count * res[design][0]
    if "library" in res:
        library_ms[kname] += count * res["library"][0]
    if route == "window":
        alt[("narrow", "launches", kname)] += count
        for k, (t, _) in res.items():
            alt[("narrow", k, kname)] += count * t
    h, w, ci, co = shape
    phase("times", f"{kname} {batch}x{h}x{w}x{ci}->{co} (x{count}/{unit}): " + ", ".join(
        f"{k} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, spread {sp:.1%})"
        for k, (t, sp) in res.items()))


def design_times(alt, kname):
    """The JSON's per-design numbers of one conv kernel from time_conv's
    sums: window_ms, tile_ms and the narrow launches' (those routed to
    window) count and times."""
    narrow = alt[("narrow", "launches", kname)]
    return {"window_ms": alt[("window", kname)], "tile_ms": alt[("tile", kname)],
            "narrow": {"launches": narrow,
                       **{f"{k}_ms": alt[("narrow", k, kname)] if narrow else None
                          for k in ("window", "tile", "plain")},
                       "library_ms": (alt[("narrow", "library", kname)]
                                      if narrow and kname == "conv3x3" else None)}}


def narrow_line(label, alt, kname, unit) -> None:
    """The line of a pass's launches routed to window, summed: through
    window, tile, the plain version and cuDNN's one call."""
    d = design_times(alt, kname)["narrow"]
    if not d["launches"]:
        return
    lib = "none" if d["library_ms"] is None else f"{d['library_ms']:.3f} ms"
    phase("times", f"{label} {kname} narrow launches (routed to window, {d['launches']} a "
          f"{unit}): window {d['window_ms']:.3f} ms, tile {d['tile_ms']:.3f} ms, plain "
          f"{d['plain_ms']:.3f} ms, cuDNN's one call {lib}")


def time_pool(pool_shapes, ms, plain_ms, library_ms) -> None:
    """6, the pool forward at each shape of the serving forward, batch 128
    bf16: first a check that the routed design (sm90) equals the plain
    version at this size (many chunks a block: the ring wraps), then the
    times of sm90, simple, the plain version and F.max_pool2d(ceil_mode)
    on the channels_last view, in turns, each call on the next of its
    rotated copies of the input (cold L2)."""
    simple_ms = bound_ms = 0.0
    points = {"sm90": [], "simple": []}  # (bytes, ms) of each design at each shape
    for k, ((h, w, c), count) in enumerate(sorted(pool_shapes.items())):
        x = pool_input((TIME_BATCH, h, w, c), torch.bfloat16, seed=k)
        same, _ = pool_equal(pooled(x, "sm90"), maxpool2_plain(x))
        check(same, f"maxpool2 {TIME_BATCH}x{h}x{w}x{c} sm90: differs from the plain version")
        sets = cold_copies([x])
        fns = {"sm90": rotating(maxpool2, sets),
               "simple": rotating(cuda_pool._simple_forward, sets),
               "plain": rotating(maxpool2_plain, sets),
               "max_pool2d": rotating(lambda t: F.max_pool2d(nchw(t), 2, 2, ceil_mode=True), sets)}
        res = dict(zip(fns, device_ms(list(fns.values()))))
        nbytes = kernel_work("maxpool2", (h, w, c), TIME_BATCH)[1]
        t_bound = bound(0, nbytes)[0]
        ms["maxpool2"] += count * res["sm90"][0]
        simple_ms += count * res["simple"][0]
        plain_ms["maxpool2"] += count * res["plain"][0]
        library_ms["maxpool2"] += count * res["max_pool2d"][0]
        bound_ms += count * t_bound
        for d, pts in points.items():
            pts.append((nbytes, res[d][0]))
        phase("times", f"maxpool2 {TIME_BATCH}x{h}x{w}x{c} (x{count}/forward; {nbytes / 1e6:.1f} "
              f"MB, bound {t_bound:.4f} ms; {len(sets)} rotated inputs): " + ", ".join(
                  f"{d} {t:.4f} ms ({nbytes / t / 1e6:.0f} GB/s, {t_bound / t:.0%} of the bound, "
                  f"spread {sp:.1%})" for d, (t, sp) in res.items()))
    phase("times", f"maxpool2 per batch-{TIME_BATCH} forward, cold L2: sm90 {ms['maxpool2']:.3f} "
          f"ms ({bound_ms / ms['maxpool2']:.0%} of its {bound_ms:.4f} ms bound), simple "
          f"{simple_ms:.3f} ms, plain {plain_ms['maxpool2']:.3f} ms, F.max_pool2d "
          f"{library_ms['maxpool2']:.3f} ms")
    # what a launch costs before it streams: each design's time as a fixed
    # cost plus its bytes at a rate, and the card's floor for any launch
    empty = device_ms([lambda: torch.cuda._sleep(0)])[0][0]
    for d, pts in points.items():
        launch_split(f"maxpool2 {d}", pts, empty)


def check_prologue(cases, max_err, what="") -> None:
    """7: conv3x3_bn_relu_in vs its plain version at each ((H, W, Ci, Co),
    batch). Reference: the plain version in f32 on the same inputs, its
    normalized input rounded to the kernel's operand type first
    (bn_relu_plain, then conv3x3_plain in f32), so that the bounds are
    conv3x3's (phase 3). Each shape goes through its routed design, the
    window design where sm90 is routed, and the tile design."""
    n_cases, n_halo, n_design = 0, 0, Counter()
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for k, ((h, w, ci, co), batch) in enumerate(sorted(cases)):
        scale, shift = bn_inputs(ci, seed=100 + k)
        for dtype in (torch.bfloat16, torch.float32):
            x, wt, b = conv_inputs(batch, h, w, ci, co, dtype, seed=100 + k)
            # where the sm90 design runs, also with exact zeros in the border
            # rows and columns: TMA fills the halo with zeros too, and only
            # the position tells the two apart (relu(shift) > 0 inside)
            halos = (False, True) if cuda_conv._route(x, wt) == "sm90" else (False,)
            for halo in halos:
                if halo:
                    x = x.clone()
                    x[:, [0, -1]] = 0
                    x[:, :, [0, -1]] = 0
                xn = bn_relu_plain(x, scale, shift).float()
                for relu_out in (False, True):
                    for with_stats in (False, True):
                        y_ref, st_ref = conv3x3_plain(xn, wt.float(), b, relu_out=relu_out,
                                                      with_stats=with_stats)
                        for design in conv_designs(x, wt):
                            kw = dict(relu_out=relu_out, with_stats=with_stats)
                            if design == "routed":
                                y, st = routed("conv3x3_bn_relu_in", x, wt,
                                               lambda: conv3x3_bn_relu_in(x, wt, b, scale, shift,
                                                                          **kw))
                            else:
                                y, st = designed("conv3x3_bn_relu_in", design,
                                                 lambda: DESIGN_FORWARDS[design](
                                                     x, wt, b, scale, shift, **kw))
                            torch.cuda.synchronize()
                            case = (f"conv3x3_bn_relu_in {batch}x{h}x{w}x{ci}->{co} {dtype} "
                                    f"relu={relu_out} stats={with_stats} zero border={halo} "
                                    f"{design}")
                            share = rel_share(y, y_ref,
                                              2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
                            err = (y.float() - y_ref).abs().max().item()
                            check(y.dtype == dtype and share <= 1.0,
                                  f"{case}: max abs err {err:.3g}")
                            worst[dtype] = max(worst[dtype], share)
                            if with_stats:
                                st_err = (st - st_ref).abs()
                                st_tol = 1e-4 * st_ref.abs() + 1e-5 * st_ref.abs().max()
                                check(bool((st_err <= st_tol).all()),
                                      f"{case}: stats max abs err {st_err.max().item():.3g}")
                            else:
                                check(not st.any(), f"{case}: stats not zero")
                            max_err["conv3x3_bn_relu_in"] = max(max_err["conv3x3_bn_relu_in"],
                                                                err)
                            n_cases += 1
                            n_halo += halo
                            n_design[design] += 1
    phase("conv3x3_bn_relu_in", f"{what}{n_cases} cases at {len(cases)} shapes and batches "
          f"({n_halo} with a zero border; {n_design['routed']} through the routed design, "
          f"{n_design['window']} through window at shapes routed to sm90, {n_design['tile']} "
          f"through tile): match the plain version (max abs err "
          f"{max_err['conv3x3_bn_relu_in']:.3g}; largest error {worst[torch.bfloat16]:.2f} of its "
          f"bound in bf16, {worst[torch.float32]:.2f} in f32)")


def pool_bwd_case(shapes, dtype, seed, ties):
    """Inputs of one group of pool backwards on the card: per member
    (N, H, W, C) of ``shapes``, x (pool_input), y = its pool, g in x's
    type."""
    xs = [pool_input(shape, dtype, seed=seed + j, ties=ties) for j, shape in enumerate(shapes)]
    ys = [maxpool2_plain(x) for x in xs]
    gs = [torch.randn(y.shape, device="cuda").to(dtype) for y in ys]
    return xs, ys, gs


def check_pool_bwd(groups, max_err, what="") -> None:
    """8: maxpool2_backward_group vs maxpool2_bwd_plain, member by member,
    for each group of NHWC shapes (a multigrid layer's pools, as the
    training steps form them, and groups of the edge cases: odd sizes,
    lane widths 1 and 16 bytes in one group, a member off a 16-byte
    boundary, more members than one launch takes). Each group takes
    ceil(members / MAX_MEMBERS) launches of the group design; each member
    also goes through the simple design alone. Both select g or 0 per
    element, so they must be equal, under either tie rule."""
    n_cases = n_launches = 0
    for k, shapes in enumerate(groups):
        for dtype in (torch.bfloat16, torch.float32):
            for ties in (False, True):
                xs, ys, gs = pool_bwd_case(shapes, dtype, 200 + 10 * k, ties)
                if k % 3 == 2:  # every third group: its first member's x off 16 bytes
                    xs[0] = misaligned(xs[0])
                for rule in ("all", "first"):
                    before = dict(kernels.ROUTES)
                    dxs = maxpool2_backward_group(xs, ys, gs, rule)
                    want = -(-len(shapes) // cuda_pool.MAX_MEMBERS)
                    check(routes_since(before) == {r: want * (r == ("maxpool2_bwd", "group"))
                                                   for r in kernels.ROUTES},
                          f"maxpool2_bwd group {shapes}: launched {routes_since(before)}, "
                          f"expected {want} through group")
                    n_launches += want
                    for x, y, g, dx in zip(xs, ys, gs, dxs):
                        ref = maxpool2_bwd_plain(x, y, g, rule)
                        simple = cuda_pool._simple_backward(x, y, g, rule)
                        torch.cuda.synchronize()
                        err = (dx.float() - ref.float()).abs().max().item()
                        max_err["maxpool2_bwd"] = max(max_err["maxpool2_bwd"], err)
                        check(dx.dtype == dtype and torch.equal(dx, ref) and torch.equal(simple, ref),
                              f"maxpool2_bwd {tuple(x.shape)} in group {shapes} {dtype} "
                              f"ties={rule}: the group or the simple design differs from the "
                              f"plain version (max abs err {err:.3g})")
                        n_cases += 1
    phase("maxpool2_bwd", f"{what}{n_cases} members in {len(groups)} groups, {n_launches} "
          f"group launches (bf16 and f32, both tie rules; ties at 0 and > 0, NaN, all -inf "
          f"windows; every third group with a member off 16 bytes): the group and the simple "
          f"design equal to the plain version")


def edge_groups() -> list:
    """The pool backward's edge groups: each of the first four edge shapes
    alone (odd sizes, C of 3, 130 and 4: one-element lanes), the four
    together (lane widths 1 and 16 bytes in one launch), and
    MAX_MEMBERS + 1 members (two launches)."""
    edges = POOL_EDGE_SHAPES[:4]
    many = [(2, 4 + j, 6 + j, 8 * (j + 1)) for j in range(cuda_pool.MAX_MEMBERS + 1)]
    return [(shape,) for shape in edges] + [tuple(edges), tuple(many)]


def check_grads() -> None:
    """9: the autograd Functions (kernel forward; cuDNN dgrad and wgrad
    and the elementwise reductions backward) vs autograd of the plain
    versions, f32 without TF32: summation order only. Without relu_out,
    as the training path calls them: with it, each side masks its
    gradient by its own y > 0, and the two forwards round some y to
    opposite sides of 0 (tests/test_torch_conv3x3.py holds relu_out's
    backward against jax.grad on the CPU)."""
    worst = 0.0
    for k, (n, h, w, ci, co) in enumerate([(4, 28, 28, 32, 32), (4, 14, 14, 64, 64),
                                           (2, 7, 7, 128, 128)]):
        x, wt, b = conv_inputs(n, h, w, ci, co, torch.float32, seed=300 + k)
        scale, shift = bn_inputs(ci, seed=300 + k)
        r = torch.randn((n, h, w, co), device="cuda")
        for fn, plain, extra in ((conv3x3, conv3x3_plain, ()),
                                 (conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain, (scale, shift))):
            grads = []
            for f in (fn, plain):
                ins = [t.clone().requires_grad_() for t in (x, wt, b, *extra)]
                y, _ = f(*ins)
                (y * r).sum().backward()
                grads.append([t.grad for t in ins])
            for name, g, g_ref in zip("x w b scale shift".split(), *grads):
                share = rel_share(g, g_ref, 1e-4)
                check(share <= 1.0, f"{fn.__name__} {n}x{h}x{w}x{ci}->{co}: d{name} differs "
                      f"from the plain autograd's")
                worst = max(worst, share)
    # the first-tie rule is torch max_pool2d's own: its autograd is the reference
    for dtype in (torch.float32, torch.bfloat16):
        x = pool_input((4, 28, 28, 64), dtype, seed=310, ties=True).nan_to_num(0.0)
        grads = []
        for f in (lambda t: maxpool2(t, "first"), maxpool2_plain):
            xt = x.clone().requires_grad_()
            f(xt).float().sin().sum().backward()
            grads.append(xt.grad)
        check(torch.equal(*grads), f"maxpool2 (first-tie rule) {dtype}: gradient differs from "
              f"max_pool2d's")
    phase("grads", f"conv3x3 and conv3x3_bn_relu_in gradients match plain autograd (largest "
          f"error {worst:.2f} of its bound, rtol 1e-4); maxpool2 first-tie gradients equal "
          f"max_pool2d's")


def check_train(name, train_routes) -> dict:
    """10: the training path, through the entry point a user calls."""
    t0 = time.perf_counter()
    trainer = Trainer(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    x, y = synthetic_batch(TRAIN_BATCH, seed=1)
    phase("train", f"R-MG-{DEPTH}, seeded random weights, bf16 on {name}: built in "
          f"{time.perf_counter() - t0:.1f} s; {TRAIN_STEPS} steps at batch {TRAIN_BATCH} on one "
          f"batch, lr {TRAIN_RULE['lr']}, wd {TRAIN_RULE['wd']}")
    kernels.reset_launches()
    losses, prev = [], dict(kernels.LAUNCHES)
    for i in range(TRAIN_STEPS):
        prev_routes = dict(kernels.ROUTES)
        m = trainer.step(x, y, TRAIN_RULE["lr"], TRAIN_RULE["wd"])
        now = dict(kernels.LAUNCHES)
        got = {k: now[k] - prev[k] for k in now}
        check(got == PER_STEP, f"step {i}: kernel launches {got}, expected {PER_STEP}")
        check(routes_since(prev_routes) == train_routes, f"step {i}: conv and pool designs "
              f"{routes_since(prev_routes)}, predicted {train_routes}")
        prev = now
        losses.append({k: float(v) for k, v in m.items()})
    launches = dict(kernels.LAUNCHES)
    loss = [m["loss"] for m in losses]
    check(all(np.isfinite(loss)), f"non-finite loss {loss}")
    check(loss[-1] < loss[0], f"the loss did not fall: {loss}")
    phase("train", "losses " + ", ".join(f"{v:.4f}" for v in loss) + "; top-1 "
          + ", ".join(f"{m['top1']:.3f}" for m in losses)
          + f"; launches per step {PER_STEP}, total {launches}; conv and pool designs per step "
          f"as predicted")

    # one f32 step on the card (kernels + cuDNN without TF32) against the
    # same step of the port's plain path on the CPU
    x2, y2 = synthetic_batch(F32_STEP_BATCH, seed=2)
    res = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(RMG34, seed=0, device=dev, compute_dtype=torch.float32)
        before, _ = export_jax_tree(tr.model)
        m = tr.step(x2, y2, TRAIN_RULE["lr"], TRAIN_RULE["wd"])
        res[dev] = (float(m["loss"]), before, *export_jax_tree(tr.model))
    (l_gpu, p0, p_gpu, s_gpu), (l_cpu, _, p_cpu, s_cpu) = res["cuda"], res["cpu"]
    # the f32 serving forward agrees to 1e-5 of the log-probs' scale
    # (phase 5); the loss is a mean of log-probs
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"f32 step loss: card {l_gpu} vs CPU {l_cpu}")
    # the update of all parameters together: |change on the card - change
    # on the CPU| / |change on the CPU| (L2 over every parameter); the
    # running stats relative to their scale
    d_gpu = np.concatenate([(a - o).ravel() for a, o in zip(flat(p_gpu), flat(p0))])
    d_cpu = np.concatenate([(c - o).ravel() for c, o in zip(flat(p_cpu), flat(p0))])
    upd = float(np.linalg.norm(d_gpu - d_cpu) / np.linalg.norm(d_cpu))
    st = max(float(np.abs(a - c).max() / max(np.abs(c).max(), 1e-12))
             for a, c in zip(flat(s_gpu), flat(s_cpu)))
    check(upd <= F32_STEP_PARAM_BOUND and st <= F32_STEP_STATS_BOUND,
          f"f32 step, card vs CPU: update err {upd:.3g} (bound {F32_STEP_PARAM_BOUND}), "
          f"running stats err {st:.3g} (bound {F32_STEP_STATS_BOUND})")
    phase("train", f"f32 step on the card vs the plain CPU step, batch {F32_STEP_BATCH}: loss "
          f"{l_gpu:.6f} vs {l_cpu:.6f}; parameter update err {upd:.3g} of its L2 norm (bound "
          f"{F32_STEP_PARAM_BOUND}); running stats err {st:.3g} of their scale (bound "
          f"{F32_STEP_STATS_BOUND})")
    return launches


def flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat(tree[k])]
    return [tree]


def pool_bwd_operands(shape, seed):
    """One member's bf16 inputs for timing, (x, y, g, first-tie indices):
    ReLU-like x with ties; aten's backward starts from the indices, made
    here, outside the timed calls."""
    x = pool_input(shape, torch.bfloat16, seed, ties=True)
    y = maxpool2_plain(x)
    g = torch.randn(y.shape, device="cuda").to(torch.bfloat16)
    return x, y, g, F.max_pool2d(nchw(x), 2, 2, ceil_mode=True, return_indices=True)[1]


def members(flat):
    """(xs, ys, gs, idxs) of a flat tuple of pool_bwd_operands"""
    return flat[0::4], flat[1::4], flat[2::4], flat[3::4]


POOL_BWD_FNS = {
    "group": lambda xs, ys, gs, ids: maxpool2_backward_group(xs, ys, gs, "first"),
    "simple": lambda xs, ys, gs, ids: [cuda_pool._simple_backward(x, y, g, "first")
                                       for x, y, g in zip(xs, ys, gs)],
    "plain": lambda xs, ys, gs, ids: [maxpool2_bwd_plain(x, y, g, "first")
                                      for x, y, g in zip(xs, ys, gs)],
    "library": lambda xs, ys, gs, ids: [torch.ops.aten.max_pool2d_with_indices_backward(
        nchw(g), nchw(x), [2, 2], [2, 2], [0, 0], [1, 1], True, i)
        for x, g, i in zip(xs, gs, ids)]}


def time_pool_bwd(groups, batch, per, seed, unit, windows=5, split=False) -> dict:
    """The pool backward at each distinct group of a pass (``groups``: the
    recorded Counter, launches a micro-batch), at ``batch`` in bf16 under
    the first-tie rule, cold (each call on the next of the group's copies,
    COLD_BYTES in all), in turns: the group design (one launch), the
    simple design summed over the members, the plain version and aten's
    max_pool2d_with_indices_backward a member (not quite the same
    function). After a check at this size that the group equals the
    plain version. Returns {design: ms summed over the pass's launches,
    ``per`` micro-batches}. With ``split``, also each member shape alone
    through both designs, and each design's time as a fixed cost a launch
    plus its bytes at a rate (least squares), beside an empty kernel's."""
    sums = dict.fromkeys(POOL_BWD_FNS, 0.0)
    points = {"group": [], "simple": []}  # (bytes, ms) of one launch
    for k, (key, count) in enumerate(sorted(groups.items())):
        flat = [t for j, shape in enumerate(key)
                for t in pool_bwd_operands((batch, *shape), seed + 10 * k + j)]
        xs, ys, gs, _ = members(flat)
        for dx, x, y, g in zip(maxpool2_backward_group(xs, ys, gs, "first"), xs, ys, gs):
            check(torch.equal(dx, maxpool2_bwd_plain(x, y, g, "first")),
                  f"maxpool2_bwd group {key} at batch {batch}: differs from the plain version")
        sets = cold_copies(flat)
        fns = {d: rotating(lambda *f, fn=fn: fn(*members(f)), sets)
               for d, fn in POOL_BWD_FNS.items()}
        res = dict(zip(fns, device_ms(list(fns.values()), windows)))
        nbytes = kernel_work("maxpool2_bwd", key, batch)[1]
        t_bound = bound(0, nbytes)[0]
        for d in sums:
            sums[d] += per * count * res[d][0]
        points["group"].append((nbytes, res["group"][0]))
        phase("times", f"maxpool2_bwd {batch}x{' + '.join('x'.join(map(str, m)) for m in key)} "
              f"(x{per * count}/{unit}; {nbytes / 1e6:.2f} MB, bound {t_bound * 1e3:.2f} us; "
              f"{len(sets)} rotated input sets): " + ", ".join(
                  f"{d} {t:.4f} ms ({t_bound / t:.0%} of the bound, spread {sp:.1%})"
                  for d, (t, sp) in res.items()))
    if split:
        shapes = sorted({m for key in groups for m in key})
        for k, shape in enumerate(shapes):
            sets = cold_copies(list(pool_bwd_operands((batch, *shape), seed + 500 + k)))
            res = device_ms([rotating(lambda *f, d=d: POOL_BWD_FNS[d](*members(f)), sets)
                             for d in points], windows)
            nbytes = kernel_work("maxpool2_bwd", (shape,), batch)[1]
            for d, (t, _) in zip(points, res):
                points[d].append((nbytes, t))
        empty = device_ms([lambda: torch.cuda._sleep(0)])[0][0]
        for d, pts in points.items():
            launch_split(f"maxpool2_bwd {d}", pts, empty)
    return sums


def launch_split(what, points, empty) -> None:
    """A design's time a launch as a fixed cost plus its bytes at a rate:
    the least-squares line through its (bytes, ms) points."""
    slope, fixed = np.polyfit([b for b, _ in points], [t for _, t in points], 1)
    phase("times", f"{what}: {fixed * 1e3:.2f} us a launch + its bytes at {1e-9 / slope:.2f} "
          f"TB/s (least squares over {len(points)} launches); an empty kernel "
          f"(torch.cuda._sleep(0)) takes {empty * 1e3:.2f} us back to back")


def time_train(name, train_shapes, ms, plain_ms, alt, library_ms, simple_ms) -> None:
    """11: the training step and the two kernels it adds, at batch 128
    bf16; the pool backward on rotated inputs (cold L2), as the forward
    in phase 6, each group of the step through both designs
    (time_pool_bwd, with the fixed-cost split)."""
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    x, y = synthetic_batch(TIME_BATCH, seed=4)
    xt = torch.from_numpy(x).cuda().to(torch.bfloat16)
    yt = torch.from_numpy(y).cuda()
    (t_step, s_step), = interleaved_ms([lambda: trainer.step(xt, yt, TRAIN_RULE["lr"],
                                                             TRAIN_RULE["wd"])], min_reps=3)
    phase("times", f"training step, R-MG-{DEPTH} bf16, batch {TIME_BATCH}: {t_step:.2f} ms "
          f"(spread {s_step:.1%}) = {TIME_BATCH / t_step * 1e3:.1f} img/s on {name}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del trainer
    for k, ((h, w, ci, co), count) in enumerate(sorted(train_shapes["conv3x3_bn_relu_in"].items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=400 + k)
        fns = conv_fns(x, wt, b, bn_inputs(ci, seed=400 + k))
        time_conv("conv3x3_bn_relu_in", (h, w, ci, co), count, "step", fns, ms, plain_ms, alt,
                  library_ms)
    pool = time_pool_bwd(train_shapes["maxpool2_bwd"], TIME_BATCH, 1, 500, "step", split=True)
    ms["maxpool2_bwd"], plain_ms["maxpool2_bwd"] = pool["group"], pool["plain"]
    library_ms["maxpool2_bwd"], simple_ms["maxpool2_bwd"] = pool["library"], pool["simple"]
    bound_ms = path_bounds(train_shapes, TIME_BATCH)["maxpool2_bwd"][2]
    phase("times", f"conv3x3_bn_relu_in per batch-{TIME_BATCH} training step: kernel "
          f"{ms['conv3x3_bn_relu_in']:.3f} ms (the window design alone "
          f"{alt[('window', 'conv3x3_bn_relu_in')]:.3f} ms, the tile design alone "
          f"{alt[('tile', 'conv3x3_bn_relu_in')]:.3f} ms), plain "
          f"{plain_ms['conv3x3_bn_relu_in']:.3f} ms")
    narrow_line(f"R-MG-{DEPTH}", alt, "conv3x3_bn_relu_in", f"batch-{TIME_BATCH} step")
    phase("times", f"maxpool2_bwd per batch-{TIME_BATCH} training step, cold L2: group "
          f"{ms['maxpool2_bwd']:.3f} ms in {PER_STEP['maxpool2_bwd']} launches "
          f"({bound_ms / ms['maxpool2_bwd']:.0%} of its {bound_ms:.4f} ms bound), simple "
          f"{simple_ms['maxpool2_bwd']:.3f} ms in {PER_STEP['maxpool2']}, plain "
          f"{plain_ms['maxpool2_bwd']:.3f} ms, aten's max_pool2d_with_indices_backward "
          f"{library_ms['maxpool2_bwd']:.3f} ms")

# ------------------------------------------------------------ the CIFAR zoo

# each CIFAR net at its recipe's depth, micro-batch and iterSize
# (scripts/cifar/*.sh: -nLayer, -batchSize, -iterSize)
CIFAR_RECIPES = {"cifar/nmg": (2, 128, 1), "cifar/rnmg": (3, 64, 2), "cifar/pnmg": (3, 128, 1),
                 "cifar/prnmg": (1, 64, 2), "cifar/resnet": (4, 64, 2), "cifar/vgg": (4, 128, 1)}
CIFAR_TIMED = "cifar/prnmg"  # runs every op of the slice and all four kernels


def launch_counts(conv, prologue, pool, pool_bwd, conv_i8=0, quant_i8=0) -> dict:
    return {"conv3x3": conv, "conv3x3_bn_relu_in": prologue, "maxpool2": pool,
            "maxpool2_bwd": pool_bwd, "conv_i8": conv_i8, "quant_i8": quant_i8}


# launches per serving forward (BN folded) and per training micro-batch
# (forward and backward) of each CIFAR net at its recipe depth: one
# conv3x3 per 3x3/s1 conv or exchange part (cuDNN takes the 1x1 convs and
# the folded up parts), one maxpool2 per exchange down part, MgPool scale
# and Pool2. In training, rnmg and prnmg feed each 3x3 residual stage 2
# its same-scale part through conv3x3_bn_relu_in. With --isDropout the
# dropped parts are materialized, so prnmg's blocks 2-5 take conv3x3
# instead (block 1 has no dropout)
CIFAR_PER_FORWARD = {
    "cifar/nmg": launch_counts(36, 0, 28, 0), "cifar/rnmg": launch_counts(117, 0, 66, 0),
    "cifar/pnmg": launch_counts(72, 0, 42, 0), "cifar/prnmg": launch_counts(49, 0, 32, 0),
    "cifar/resnet": launch_counts(41, 0, 5, 0), "cifar/vgg": launch_counts(20, 0, 5, 0)}
# (the pool backward one launch a layer's group of pools: nmg's 28 pools
# in 14 launches, rnmg's 66 in 35, pnmg's 42 in 23, prnmg's 32 in 17; the
# single-grid resnet and vgg pool one array a launch)
CIFAR_PER_MICRO = {
    "cifar/nmg": launch_counts(36, 0, 28, 14), "cifar/rnmg": launch_counts(81, 36, 66, 35),
    "cifar/pnmg": launch_counts(72, 0, 42, 23), "cifar/prnmg": launch_counts(35, 14, 32, 17),
    "cifar/resnet": launch_counts(41, 0, 5, 5), "cifar/vgg": launch_counts(20, 0, 5, 5)}
PRNMG_DROPOUT_PER_MICRO = launch_counts(58, 5, 32, 17)
CIFAR_SERVE_BATCH = 128
CIFAR_IMAGE = (32, 32, 3)
# the check steps' rate: a hundredth of the epoch-1 rate (0.1 under both
# the step and the log-linear rule). From a random init the residual nets
# (rnmg, resnet) start at losses of 9-11 and overshoot a fixed batch at
# 0.01: their losses rise from the second step, on the card and on the
# CPU alike (probe_cifar_lr.py); each net's own weight decay (5e-4)
CIFAR_LR = 1e-3
# the f32 card-vs-CPU step of each CIFAR net: 16 images as two
# micro-batches of 8 (the BNs of the 1x1 grids normalize over the
# micro-batch alone). Some nets' steps are ill-conditioned at any batch:
# moving the images by one part in 1e6 moves the CPU's own update of
# cifar/vgg by 1.4-2.1% of its norm and of cifar/pnmg by up to 2.0%
# (probe_cifar_step.py, 8 to 32 images a micro-batch). So a net's update
# bound is F32_STEP_PARAM_BOUND or, where larger, CIFAR_F32_OWN_FACTOR
# times that change of the CPU's own step, measured in the same run
CIFAR_F32_BATCH = 16
CIFAR_F32_OWN_FACTOR = 3


def cifar_opts(net, dropout=False) -> NetOpts:
    return NetOpts(netType=net, nLayer=CIFAR_RECIPES[net][0], isDropout=dropout)


def record_cifar() -> dict:
    """{net: (serving forward's shapes, training micro-batch's shapes)},
    recorded on the CPU, their calls checked against the pinned counts."""
    rec = {}
    for net in CIFAR_RECIPES:
        rec[net] = (record_kernel_shapes(False, cifar_opts(net)),
                    record_kernel_shapes(True, cifar_opts(net)))
        for what, shapes, want in (("forward", rec[net][0], CIFAR_PER_FORWARD[net]),
                                   ("training micro-batch", rec[net][1], CIFAR_PER_MICRO[net])):
            got = {k: sum(c.values()) for k, c in shapes.items()}
            check(got == want, f"{net}: the CPU {what} made kernel calls {got}, expected {want}")
        phase("cifar route", f"{net} (nLayer {CIFAR_RECIPES[net][0]}) per forward: "
              + ", ".join(f"{k} {r} {n}" for (k, r), n in predicted_routes(rec[net][0]).items()
                          if n)
              + "; per training micro-batch: "
              + ", ".join(f"{k} {r} {n}" for (k, r), n in predicted_routes(rec[net][1]).items()
                          if n))
    return rec


def check_cifar_kernels(rec, max_err) -> None:
    """12: each kernel vs its plain version at every shape the six nets
    give it: the serving forward's at batch 128, the training step's at
    the recipe's micro-batch."""
    conv, pro, pool, pool_bwd = set(), set(), set(), set()
    for net, (serve, train) in rec.items():
        micro = CIFAR_RECIPES[net][1]
        for shapes, batch in ((serve, CIFAR_SERVE_BATCH), (train, micro)):
            conv |= {(shape, batch) for shape in shapes["conv3x3"]}
            pool |= {(batch, *shape) for shape in shapes["maxpool2"]}
        pro |= {(shape, micro) for shape in train["conv3x3_bn_relu_in"]}
        pool_bwd |= {tuple((micro, *shape) for shape in key) for key in train["maxpool2_bwd"]}
    check_conv(sorted(conv), max_err, "CIFAR: ", slices=True)
    check_pool(sorted(pool), max_err, "CIFAR: ")
    check_prologue(sorted(pro), max_err, "CIFAR: ")
    check_pool_bwd(sorted(pool_bwd), max_err, "CIFAR: ")


def logprob_checks(what, y, batch, classes=100) -> None:
    lse = torch.logsumexp(y, dim=-1)
    check(y.shape == (batch, classes) and y.dtype == torch.float32,
          f"{what}: output {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()), f"{what}: non-finite log-probs")
    check(bool((lse.abs() < 1e-3).all()), f"{what}: logsumexp {lse.abs().max().item():.3g}")


def check_cifar_serve(name, rec) -> dict:
    """13: each CIFAR net served (BN folded, bf16) at batch 128 through
    Server: finite log-probs whose rows are distributions, the pinned
    launches per forward through the predicted designs; cifar/prnmg's
    f32 forward on the card vs the plain CPU forward. Returns {net:
    Counter of its launches}."""
    launches = {net: Counter() for net in CIFAR_RECIPES}
    x = np.random.default_rng(11).standard_normal((CIFAR_SERVE_BATCH, *CIFAR_IMAGE),
                                                  dtype=np.float32)
    for net in CIFAR_RECIPES:
        t0 = time.perf_counter()
        server = Server(cifar_opts(net), seed=0, device="cuda", compute_dtype=torch.bfloat16)
        built = time.perf_counter() - t0
        kernels.reset_launches()
        y = server.predict(x)
        got, routes = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
        torch.cuda.synchronize()
        check(got == CIFAR_PER_FORWARD[net], f"{net}: launches per forward {got}, expected "
              f"{CIFAR_PER_FORWARD[net]}")
        check(routes == predicted_routes(rec[net][0]), f"{net}: conv and pool designs {routes}, "
              f"predicted {predicted_routes(rec[net][0])}")
        logprob_checks(net, y, CIFAR_SERVE_BATCH)
        launches[net].update(got)
        phase("cifar serve", f"{net} (nLayer {CIFAR_RECIPES[net][0]}), BN folded, bf16, batch "
              f"{CIFAR_SERVE_BATCH} on {name} (built in {built:.1f} s): (B, 100) finite f32 "
              f"log-probs, rows sum to 1; launches {got}, designs as predicted")
    xs = x[:2]
    y_gpu = Server(seed=0, device="cuda", compute_dtype=torch.float32,
                   opt=cifar_opts(CIFAR_TIMED)).predict(xs).cpu()
    y_cpu = Server(seed=0, device="cpu", compute_dtype=torch.float32,
                   opt=cifar_opts(CIFAR_TIMED)).predict(xs)
    err, scale = (y_gpu - y_cpu).abs().max().item(), y_cpu.abs().max().item()
    check(err <= 1e-5 * scale, f"{CIFAR_TIMED} f32 forward: card vs CPU max abs err {err:.3g} "
          f"(scale {scale:.3g})")
    phase("cifar serve", f"{CIFAR_TIMED} f32 forward on the card vs the plain CPU forward: max "
          f"abs log-prob err {err:.3g} (bound 1e-5 x {scale:.4g})")
    return launches


def step_error(res) -> tuple[float, float, float]:
    """(loss, update, stats) errors of a card step against a CPU step:
    res[dev] = (loss, params before, params after, stats after)."""
    (l_gpu, p0, p_gpu, s_gpu), (l_cpu, _, p_cpu, s_cpu) = res["cuda"], res["cpu"]
    d_gpu = np.concatenate([(a - o).ravel() for a, o in zip(flat(p_gpu), flat(p0))])
    d_cpu = np.concatenate([(c - o).ravel() for c, o in zip(flat(p_cpu), flat(p0))])
    upd = float(np.linalg.norm(d_gpu - d_cpu) / np.linalg.norm(d_cpu))
    st = max(float(np.abs(a - c).max() / max(np.abs(c).max(), 1e-12))
             for a, c in zip(flat(s_gpu), flat(s_cpu)))
    return abs(l_gpu - l_cpu) / abs(l_cpu), upd, st


def check_cifar_train(name, rec) -> dict:
    """14: each CIFAR net takes 4 bf16 steps through Trainer at its
    recipe's micro-batch and iterSize on one fixed batch: the loss stays
    finite and falls, with the pinned launches per step through the
    predicted designs; cifar/prnmg with --isDropout takes one step (its
    masked parts go through conv3x3); one f32 step of each net on the
    card vs the same step on the CPU. Returns {net: Counter of its
    launches}."""
    launches = {net: Counter() for net in CIFAR_RECIPES}
    for net in CIFAR_RECIPES:
        n_layer, micro, iters = CIFAR_RECIPES[net]
        trainer = Trainer(seed=0, device="cuda", compute_dtype=torch.bfloat16, iter_size=iters,
                          opt=cifar_opts(net))
        wd = trainer.net.train_rule(1, trainer.opt)["wd"]
        x, y = synthetic_batch(micro * iters, seed=1, n_classes=100, shape=CIFAR_IMAGE)
        want = {k: iters * n for k, n in CIFAR_PER_MICRO[net].items()}
        want_routes = {k: iters * n for k, n in predicted_routes(rec[net][1]).items()}
        kernels.reset_launches()
        losses = []
        for i in range(TRAIN_STEPS):
            prev, prev_routes = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
            m = trainer.step(x, y, CIFAR_LR, wd)
            got = {k: kernels.LAUNCHES[k] - prev[k] for k in prev}
            check(got == want, f"{net} step {i}: launches {got}, expected {want}")
            check(routes_since(prev_routes) == want_routes, f"{net} step {i}: conv and pool "
                  f"designs {routes_since(prev_routes)}, predicted {want_routes}")
            losses.append(float(m["loss"]))
        launches[net].update(kernels.LAUNCHES)
        check(all(np.isfinite(losses)), f"{net}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{net}: the loss did not fall: {losses}")
        phase("cifar train", f"{net} (nLayer {n_layer}), bf16, {micro} x {iters} on {name}: "
              f"losses " + ", ".join(f"{v:.4f}" for v in losses)
              + f" at lr {CIFAR_LR}, wd {wd}; launches per step {want}, designs as predicted")
        del trainer

    micro, iters = CIFAR_RECIPES[CIFAR_TIMED][1:]
    trainer = Trainer(seed=0, device="cuda", compute_dtype=torch.bfloat16, iter_size=iters,
                      opt=cifar_opts(CIFAR_TIMED, dropout=True))
    x, y = synthetic_batch(micro * iters, seed=1, n_classes=100, shape=CIFAR_IMAGE)
    kernels.reset_launches()
    loss = float(trainer.step(x, y, CIFAR_LR, 5e-4)["loss"])
    want = {k: iters * n for k, n in PRNMG_DROPOUT_PER_MICRO.items()}
    check(dict(kernels.LAUNCHES) == want and np.isfinite(loss),
          f"{CIFAR_TIMED} --isDropout: launches {kernels.LAUNCHES}, expected {want}; loss {loss}")
    launches[CIFAR_TIMED].update(kernels.LAUNCHES)
    phase("cifar train", f"{CIFAR_TIMED} --isDropout, one step, {micro} x {iters}: loss "
          f"{loss:.4f}; launches {want}")
    del trainer

    x2, y2 = synthetic_batch(CIFAR_F32_BATCH, seed=2, n_classes=100, shape=CIFAR_IMAGE)
    moved = x2 * (1 + 1e-6 * np.random.default_rng(3).standard_normal(x2.shape,
                                                                      dtype=np.float32))
    for net in CIFAR_RECIPES:
        res = {}
        for key, dev, x in (("cuda", "cuda", x2), ("cpu", "cpu", x2), ("moved", "cpu", moved)):
            tr = Trainer(cifar_opts(net), seed=0, device=dev, compute_dtype=torch.float32,
                         iter_size=2)
            before, _ = export_jax_tree(tr.model)
            m = tr.step(x, y2, 0.1, 5e-4)
            res[key] = (float(m["loss"]), before, *export_jax_tree(tr.model))
        loss_err, upd, st = step_error(res)
        own = step_error({"cuda": res["moved"], "cpu": res["cpu"]})[1]
        bound = max(F32_STEP_PARAM_BOUND, CIFAR_F32_OWN_FACTOR * own)
        check(loss_err <= 1e-4 and upd <= bound and st <= F32_STEP_STATS_BOUND,
              f"{net} f32 step, card vs CPU: loss err {loss_err:.3g} (bound 1e-4), update err "
              f"{upd:.3g} (bound {bound:.3g}; the CPU's own under moved images {own:.3g}), "
              f"running stats err {st:.3g} (bound {F32_STEP_STATS_BOUND})")
        phase("cifar train", f"{net} f32 step on the card vs the plain CPU step, "
              f"{CIFAR_F32_BATCH // 2} x 2 at lr 0.1: loss {res['cuda'][0]:.6f} vs "
              f"{res['cpu'][0]:.6f}; parameter update err {upd:.3g} of its L2 norm (bound "
              f"{bound:.3g}; images moved by 1e-6 move the CPU's own update by {own:.3g}); "
              f"running stats err {st:.3g} of their scale (bound {F32_STEP_STATS_BOUND})")
    return launches


def interleaved_ms(fns, windows=5, min_reps=1):
    """Median and relative spread (max - min over median) of each
    function's per-call time on the card's clock, host included: each
    window times back-to-back calls (at least ``min_reps``, enough to
    fill ~20 ms) of every function with CUDA events, in an order that
    rotates from window to window. Returns [(median, spread)] in the
    order of fns."""
    reps = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps.append(max(min_reps, min(50, int(0.02 / max(time.perf_counter() - t0, 1e-6)))))
    per = [[] for _ in fns]
    for i in range(windows):
        for j in [(i + k) % len(fns) for k in range(len(fns))]:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps[j]):
                fns[j]()
            b.record()
            b.synchronize()
            per[j].append(a.elapsed_time(b) / reps[j])
    return [(statistics.median(p), (max(p) - min(p)) / statistics.median(p)) for p in per]


# the port's kernels as the profiler names them (their launches are counted)
PORT_KERNEL_NAMES = ("conv3x3", "maxpool2", "conv_i8", "quant_kernel", "absmax_kernel")


def profile_kernels(fn, tries=3):
    """One profiled call of fn: (the card's busy ms, the sum of the device
    times of the kernels and copies it ran; {kernel name: (launches,
    ms)}; the call's wall ms under the profiler; the sum of
    key_averages()' self device times, which counts a kernel launched
    by a torch op twice: as itself and on the host event that launched
    it; the port's kernel launches in the trace; those the counters
    saw). A trace could miss a call's first kernels (measured: 17 of the
    356 launches of an int8 forward, in every try, late in this script's
    run): an untimed call runs inside the trace first, and the timed
    call's kernels are those inside its annotation's range on the card's
    timeline. The call is profiled again, up to ``tries`` times, until
    the trace holds every launch of the port's kernels that the counters
    saw. Two calls a trace: the trace of a step holds tens of thousands
    of events, and with three calls phase 20 took 169 s (the log's
    timestamps), most of it reading the traces of prnmg.mnist and
    prnmgseg."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("profiled call"):
                before = sum(kernels.LAUNCHES.values())
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                counted = sum(kernels.LAUNCHES.values()) - before
        events = prof.events()
        # the annotation's range on the card: from its first kernel to its last
        span = [e.time_range for e in events
                if e.name == "profiled call" and e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in events:
            if (e.device_type == DeviceType.CUDA and e.name != "profiled call" and span
                    and span[0].start <= e.time_range.start and e.time_range.end <= span[0].end):
                n, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
        seen = sum(n for k, (n, _) in by_name.items() if any(p in k for p in PORT_KERNEL_NAMES))
        if seen >= counted:
            break
    both = sum(e.self_device_time_total for e in prof.key_averages()
               if e.key != "profiled call") / 1e3 / 2  # two calls in the trace
    return sum(t for _, t in by_name.values()), by_name, wall, both, seen, counted


def device_busy_ms(fn):
    """The card's busy time of one call of fn (profile_kernels) and the
    wall time of the same call, or None where the trace holds no device
    time."""
    busy, _, wall, _, _, _ = profile_kernels(fn)
    return (busy, wall) if busy > 0 else None


def time_end_to_end(tag, label, name, fns, imgs) -> None:
    """End-to-end times of ``fns`` (what -> function), interleaved on the
    card's clock (host included), with images/s from ``imgs`` (what ->
    images a call), and the card's busy share of each from a profile of
    one call."""
    res = dict(zip(fns, interleaved_ms(list(fns.values()))))
    for what, (t, sp) in res.items():
        phase(tag, f"{label} bf16 {what}: {t:.3f} ms (median of 5 interleaved windows, spread "
              f"{sp:.1%}) = {imgs[what] / t * 1e3:.1f} img/s on {name}")
    for what, fn in fns.items():
        busy = device_busy_ms(fn)
        phase(tag, f"{label} bf16 {what}, profiled: " + (
            "no device time in the trace (not measured)" if busy is None else
            f"card busy {busy[0]:.3f} ms a call, {busy[1]:.3f} ms wall under the profiler; "
            f"against the median above the card is idle {1 - busy[0] / res[what][0]:.0%}"))


def time_kernels(label, serve, train, serve_batch, micro, iters, seed=600, alternatives=True,
                 windows=5, dtype=torch.bfloat16):
    """Each kernel at a net's shapes (``serve``: its serving forward's,
    at ``serve_batch``; ``train``: its training micro-batch's, at
    ``micro``, ``iters`` a step) beside its plain version, one PyTorch
    call of the same function (cuDNN's conv, F.max_pool2d, aten's pool
    backward); the convs also through the window design (where sm90 is
    routed) and the tile design (conv_fns), with the launches routed to
    window summed (narrow_line); with ``alternatives`` the pool forward's
    simple design where the routed design is sm90; each the median of
    ``windows`` windows; the pool backward by group (time_pool_bwd:
    the group design, the simple one summed over the members, the plain
    version, aten's; with ``alternatives`` the fixed-cost split). Returns
    ({kernel: ms}, {kernel: plain ms}, {kernel: library ms}, {"maxpool2_bwd":
    the simple design's ms}, {conv kernel: design_times}) per forward
    (conv3x3, maxpool2) or per step (the other two); a kernel the net
    does not launch is left out."""
    ms, plain_ms = dict.fromkeys(KERNELS, 0.0), dict.fromkeys(KERNELS, 0.0)
    alt_ms, library_ms = dict.fromkeys(KERNELS, 0.0), dict.fromkeys(KERNELS, 0.0)
    library_ms["conv3x3_bn_relu_in"] = None
    alt = defaultdict(float)  # the convs' designs (time_conv)
    itemsize = torch.empty((), dtype=dtype).element_size()
    for k, ((h, w, ci, co), count) in enumerate(sorted(serve["conv3x3"].items())):
        xc, wt, b = conv_inputs(serve_batch, h, w, ci, co, dtype, seed=seed + k)
        time_conv("conv3x3", (h, w, ci, co), count, "forward", conv_fns(xc, wt, b), ms, plain_ms,
                  alt, library_ms, serve_batch, windows)
    for k, ((h, w, ci, co), count) in enumerate(sorted(train["conv3x3_bn_relu_in"].items())):
        xc, wt, b = conv_inputs(micro, h, w, ci, co, torch.bfloat16, seed=seed + 100 + k)
        time_conv("conv3x3_bn_relu_in", (h, w, ci, co), iters * count, "step",
                  conv_fns(xc, wt, b, bn_inputs(ci, seed=seed + 100 + k)), ms, plain_ms, alt,
                  library_ms, micro, windows)
    for k, ((h, w, c), count) in enumerate(sorted(serve["maxpool2"].items())):
        xp = pool_input((serve_batch, h, w, c), dtype, seed=seed + 200 + k)
        route = cuda_pool._route(xp)
        sets = cold_copies([xp])
        pfns = {route: rotating(maxpool2, sets),
                "plain": rotating(maxpool2_plain, sets),
                "library": rotating(lambda t: F.max_pool2d(nchw(t), 2, 2, ceil_mode=True), sets)}
        if route == "sm90" and alternatives:
            pfns["simple"] = rotating(cuda_pool._simple_forward, sets)
        pres = dict(zip(pfns, device_ms(list(pfns.values()), windows)))
        nbytes = kernel_work("maxpool2", (h, w, c), serve_batch, itemsize)[1]
        ms["maxpool2"] += count * pres[route][0]
        plain_ms["maxpool2"] += count * pres["plain"][0]
        library_ms["maxpool2"] += count * pres["library"][0]
        phase("times", f"maxpool2 {serve_batch}x{h}x{w}x{c} (x{count}/forward; "
              f"{nbytes / 1e6:.2f} MB, bound {bound(0, nbytes)[0] * 1e3:.2f} us; cold inputs): "
              + ", ".join(f"{d} {t:.4f} ms (spread {sp:.1%})" for d, (t, sp) in pres.items()))
    if train["maxpool2_bwd"]:
        pool = time_pool_bwd(train["maxpool2_bwd"], micro, iters, seed + 300, "step", windows,
                             split=alternatives)
        ms["maxpool2_bwd"], plain_ms["maxpool2_bwd"] = pool["group"], pool["plain"]
        library_ms["maxpool2_bwd"], alt_ms["maxpool2_bwd"] = pool["library"], pool["simple"]
    used = [k for k in KERNELS if (serve if k in ("conv3x3", "maxpool2") else train)[k]]
    for k in used:
        unit = (f"batch-{serve_batch} forward" if k in ("conv3x3", "maxpool2")
                else f"{micro} x {iters} step")
        lib = "none" if library_ms[k] is None else f"{library_ms[k]:.3f} ms"
        other = (f", the window design alone {alt[('window', k)]:.3f} ms, the tile design alone "
                 f"{alt[('tile', k)]:.3f} ms" if k.startswith("conv") else
                 f" (group design), the simple design {alt_ms[k]:.3f} ms" if k == "maxpool2_bwd"
                 else "")
        phase("times", f"{label} {k} per {unit}: kernel {ms[k]:.3f} ms{other}, plain "
              f"{plain_ms[k]:.3f} ms, one PyTorch call {lib}")
        if k.startswith("conv"):
            narrow_line(label, alt, k, unit)
    return ({k: ms[k] for k in used}, {k: plain_ms[k] for k in used},
            {k: library_ms[k] for k in used}, {"maxpool2_bwd": alt_ms["maxpool2_bwd"]},
            {k: design_times(alt, k) for k in used if k.startswith("conv")})


def time_cifar(name, rec):
    """15: cifar/prnmg's end-to-end times (the bf16 serving forward at
    batch 128 and at batch 1, the bf16 training step at its recipe's 64 x
    2), interleaved on the card's clock, and the card's busy share of
    each from a profile; then each kernel at prnmg's shapes (the
    forward's at batch 128, the step's at its micro-batch 64), as
    :func:`time_kernels`."""
    serve, train = rec[CIFAR_TIMED]
    micro, iters = CIFAR_RECIPES[CIFAR_TIMED][1:]
    server = Server(seed=0, device="cuda", compute_dtype=torch.bfloat16,
                    opt=cifar_opts(CIFAR_TIMED))
    trainer = Trainer(seed=0, device="cuda", compute_dtype=torch.bfloat16, iter_size=iters,
                      opt=cifar_opts(CIFAR_TIMED))
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.standard_normal((CIFAR_SERVE_BATCH, *CIFAR_IMAGE),
                                                  dtype=np.float32)).cuda()
    x, y = synthetic_batch(micro * iters, seed=4, n_classes=100, shape=CIFAR_IMAGE)
    xt, yt = torch.from_numpy(x).cuda().to(torch.bfloat16), torch.from_numpy(y).cuda()
    fns = {f"forward {CIFAR_SERVE_BATCH}": lambda: server.predict(images),
           "forward 1": lambda: server.predict(images[:1]),
           f"step {micro}x{iters}": lambda: trainer.step(xt, yt, CIFAR_LR, 5e-4)}
    time_end_to_end("cifar times", CIFAR_TIMED, name, fns,
                    {f"forward {CIFAR_SERVE_BATCH}": CIFAR_SERVE_BATCH, "forward 1": 1,
                     f"step {micro}x{iters}": micro * iters})
    del server, trainer, images
    return time_kernels(CIFAR_TIMED, serve, train, CIFAR_SERVE_BATCH, micro, iters)


def net_bounds(serve, train, serve_batch, micro, iters):
    """{kernel: (operations, bytes, bound ms, bound_by)} of a net's
    launches in one serving forward at ``serve_batch`` (conv3x3,
    maxpool2) or one ``micro`` x ``iters`` training step (the other
    two)."""
    fwd, micro_b = path_bounds(serve, serve_batch), path_bounds(train, micro)
    return {k: fwd[k] if k in ("conv3x3", "maxpool2") else
            (iters * micro_b[k][0], iters * micro_b[k][1], iters * micro_b[k][2], micro_b[k][3])
            for k in KERNELS}


def cifar_bounds(rec):
    """net_bounds of cifar/prnmg: one batch-128 serving forward, one 64 x
    2 training step."""
    serve, train = rec[CIFAR_TIMED]
    micro, iters = CIFAR_RECIPES[CIFAR_TIMED][1:]
    return net_bounds(serve, train, CIFAR_SERVE_BATCH, micro, iters)

# ------------------------------------------- the segmentation nets and PR-MG

# each net at its recipe (scripts/mnist-cluttered/*.sh, scripts/ilsvrc/prnmgseg.sh):
# its options (the recipe's -dataset, -depth, -shortcutType), -batchSize (the
# micro-batch), -iterSize, and the serving batches. prnmgseg's -iterSize 16
# is cut to 2 here for time (SEG_PRNMGSEG_RECIPE_ITERS)
SEG_RECIPES = {
    "mnist-cluttered/unet": (NetOpts(netType="mnist-cluttered/unet", dataset="mnist-sca"),
                             64, 1, (64,)),
    "mnist-cluttered/unmg": (NetOpts(netType="mnist-cluttered/unmg", dataset="mnist-seg"),
                             64, 1, (64,)),
    "mnist-cluttered/pnmg.mnist": (NetOpts(netType="mnist-cluttered/pnmg.mnist",
                                           dataset="mnist-aff"), 64, 1, (64,)),
    "mnist-cluttered/prnmg.mnist": (NetOpts(netType="mnist-cluttered/prnmg.mnist",
                                            dataset="mnist-spt"), 32, 2, (32,)),
    "ilsvrc/prnmgseg": (NetOpts(netType="ilsvrc/prnmgseg", depth=30, shortcutType="A"),
                        16, 2, (1, 128)),
}
SEG_PRNMGSEG_RECIPE_ITERS = 16
# one serving forward of PR-MG-52 (shortcut A), at this batch
PRNMGSEG52, PRNMGSEG52_BATCH = NetOpts(netType="ilsvrc/prnmgseg", depth=52, shortcutType="A"), 8
# pnmg.mnist on mnist-seg: its output conv at Co = 10 (its kernels checked in phase 17)
PNMG_SEG = NetOpts(netType="mnist-cluttered/pnmg.mnist", dataset="mnist-seg")
# launches per serving forward (BN folded) and per training micro-batch,
# counted as for the CIFAR nets. The transposed convs, the 1x1 convs and
# the stems' 7x7 convs and 3x3/2 pools take stock ops. In training a pool
# whose output reaches no loss is not differentiated: the three coarsest
# scales dropped by the mnist P-nets, the scales of unmg's head that the
# sigmoid does not read, the scales of prnmgseg's last layer that its
# classifier does not read
SEG_PER_FORWARD = {
    "mnist-cluttered/unet": launch_counts(7, 0, 3, 0),
    "mnist-cluttered/unmg": launch_counts(25, 0, 16, 0),
    "mnist-cluttered/pnmg.mnist": launch_counts(50, 0, 18, 0),
    "mnist-cluttered/prnmg.mnist": launch_counts(94, 0, 36, 0),
    "ilsvrc/prnmgseg": launch_counts(148, 0, 60, 0)}
# (the pool backward one launch a layer's group: unmg's 13 differentiated
# pools in 8 launches, pnmg.mnist's 15 in 7, prnmg.mnist's 33 in 15,
# prnmgseg's 57 in 24. In prnmgseg's last layer one pool of a group
# reaches the loss; the conv Functions leave an unread scale's cotangent
# None (set_materialize_grads(False)), so the group's other members are
# not differentiated)
SEG_PER_MICRO = {
    "mnist-cluttered/unet": launch_counts(7, 0, 3, 3),
    "mnist-cluttered/unmg": launch_counts(25, 0, 16, 8),
    "mnist-cluttered/pnmg.mnist": launch_counts(50, 0, 18, 7),
    "mnist-cluttered/prnmg.mnist": launch_counts(68, 26, 36, 15),
    "ilsvrc/prnmgseg": launch_counts(106, 42, 60, 24)}
PRNMGSEG52_PER_FORWARD = launch_counts(278, 0, 114, 0)
# the check steps' rate: the mnist nets' epoch-1 rate (0.1 under both
# their rules), at which their f32 losses fall from the first step on the
# CPU (at 0.01 unmg's fell by 0.0007 over 4 steps); prnmgseg R-MG-34's
# (TRAIN_RULE), which the ImageNet nets' epoch-1 rate of 0.1 overshoots
SEG_LR = {net: TRAIN_RULE["lr"] if net == "ilsvrc/prnmgseg" else 0.1 for net in SEG_RECIPES}
# the f32 card-vs-CPU step: two micro-batches of 4 images (2 at 224 px)
SEG_F32_MICRO = {net: 2 if net == "ilsvrc/prnmgseg" else 4 for net in SEG_RECIPES}


def record_seg() -> tuple[dict, dict]:
    """{net: (serving forward's shapes, training micro-batch's shapes)}
    of the five nets, recorded on the CPU and their calls checked against
    the pinned counts; and the serving forward's shapes of PR-MG-52
    ("depth 52") and of pnmg.mnist on mnist-seg ("mnist-seg")."""
    rec = {}
    for net, (opt, *_) in SEG_RECIPES.items():
        rec[net] = (record_kernel_shapes(False, opt), record_kernel_shapes(True, opt))
        for what, shapes, want in (("forward", rec[net][0], SEG_PER_FORWARD[net]),
                                   ("training micro-batch", rec[net][1], SEG_PER_MICRO[net])):
            got = {k: sum(c.values()) for k, c in shapes.items()}
            check(got == want, f"{net}: the CPU {what} made kernel calls {got}, expected {want}")
        phase("seg route", f"{get_spec(net).describe(opt)} per forward: "
              + ", ".join(f"{k} {r} {n}" for (k, r), n in predicted_routes(rec[net][0]).items()
                          if n)
              + "; per training micro-batch: "
              + ", ".join(f"{k} {r} {n}" for (k, r), n in predicted_routes(rec[net][1]).items()
                          if n))
    extra = {"depth 52": record_kernel_shapes(False, PRNMGSEG52),
             "mnist-seg": record_kernel_shapes(False, PNMG_SEG)}
    got = {k: sum(c.values()) for k, c in extra["depth 52"].items()}
    check(got == PRNMGSEG52_PER_FORWARD, f"PR-MG-52: the CPU forward made kernel calls {got}, "
          f"expected {PRNMGSEG52_PER_FORWARD}")
    return rec, extra


def check_seg_kernels(rec, extra, max_err) -> None:
    """17: each kernel vs its plain version at every shape the five nets
    (and pnmg.mnist on mnist-seg) give it, at each serving batch and at
    the recipe's micro-batch: bf16 and f32, the convs also through the
    window design where sm90 takes the shape and through the tile
    design, the pool forward through
    both designs where sm90 takes it. New here: Ci = 1 (the 1-channel
    stems), Co = 1 and 10 (pnmg.mnist's output conv), widths 8-32 on
    7x7 and 14x14 grids, pools of 64 px maps."""
    conv, pro, pool, pool_bwd = set(), set(), set(), set()
    # pnmg.mnist on mnist-seg at its batch (its step makes its forward's
    # calls; the pool backward's shapes are mnist-aff's)
    nets = {**rec, "mnist-seg": (extra["mnist-seg"], extra["mnist-seg"])}
    for net, (serve, train) in nets.items():
        _, micro, _, batches = SEG_RECIPES.get(net, SEG_RECIPES["mnist-cluttered/pnmg.mnist"])
        for shapes, batch in [(serve, b) for b in batches] + [(train, micro)]:
            conv |= {(shape, batch) for shape in shapes["conv3x3"]}
            pool |= {(batch, *shape) for shape in shapes["maxpool2"]}
        pro |= {(shape, micro) for shape in train["conv3x3_bn_relu_in"]}
        pool_bwd |= {tuple((micro, *shape) for shape in key) for key in train["maxpool2_bwd"]}
    check({ci for (_, _, ci, _), _ in conv} >= {1} and {co for (*_, co), _ in conv} >= {1, 10},
          "the seg shapes lack Ci = 1 or Co = 1, 10")
    check_conv(sorted(conv), max_err, "seg: ", slices=True)
    check_pool(sorted(pool), max_err, "seg: ")
    check_prologue(sorted(pro), max_err, "seg: ")
    check_pool_bwd(sorted(pool_bwd), max_err, "seg: ")


def seg_images(net, batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, *get_spec(net).image_shape),
                                                       dtype=np.float32)


def output_checks(what, y, batch, opt) -> None:
    """A classifier's (B, classes) log-probs whose rows are
    distributions, or an mnist net's (B, 64, 64, classes) probabilities
    in [0, 1]: f32 and finite."""
    spec = get_spec(opt.netType)
    if spec.target_shape(opt):
        check(y.shape == (batch, *spec.target_shape(opt)) and y.dtype == torch.float32,
              f"{what}: output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"{what}: non-finite probabilities")
        check(bool(((y >= 0) & (y <= 1)).all()), f"{what}: probabilities outside [0, 1]")
    else:
        logprob_checks(what, y, batch, spec.n_classes(opt))


def check_seg_serve(name, rec, extra) -> dict:
    """18: each net served (BN folded, bf16) through Server at its
    serving batches: its outputs checked, the pinned launches per
    forward through the predicted designs; PR-MG-52's forward at batch
    8; each net's f32 forward on the card vs the plain CPU forward.
    Returns {net: Counter of its launches}."""
    launches = {net: Counter() for net in SEG_RECIPES}
    for net, (opt, _, _, batches) in SEG_RECIPES.items():
        t0 = time.perf_counter()
        server = Server(opt, seed=0, device="cuda", compute_dtype=torch.bfloat16)
        built = time.perf_counter() - t0
        for batch in batches:
            kernels.reset_launches()
            y = server.predict(seg_images(net, batch, seed=11))
            got, routes = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
            torch.cuda.synchronize()
            check(got == SEG_PER_FORWARD[net], f"{net} batch {batch}: launches per forward {got}, "
                  f"expected {SEG_PER_FORWARD[net]}")
            check(routes == predicted_routes(rec[net][0]), f"{net}: conv and pool designs "
                  f"{routes}, predicted {predicted_routes(rec[net][0])}")
            output_checks(f"{net} batch {batch}", y, batch, opt)
            launches[net].update(got)
            phase("seg serve", f"{get_spec(net).describe(opt)}, BN folded, bf16, batch {batch} "
                  f"on {name} (built in {built:.1f} s): {tuple(y.shape)} finite f32 outputs in "
                  f"range; launches {got}, designs as predicted")
        del server
    server = Server(PRNMGSEG52, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    kernels.reset_launches()
    y = server.predict(seg_images("ilsvrc/prnmgseg", PRNMGSEG52_BATCH, seed=11))
    got = dict(kernels.LAUNCHES)
    check(got == PRNMGSEG52_PER_FORWARD and dict(kernels.ROUTES) == predicted_routes(
        extra["depth 52"]), f"PR-MG-52: launches {got} and designs {kernels.ROUTES}, expected "
        f"{PRNMGSEG52_PER_FORWARD}")
    output_checks("PR-MG-52", y, PRNMGSEG52_BATCH, PRNMGSEG52)
    launches["ilsvrc/prnmgseg"].update(got)
    phase("seg serve", f"{get_spec('ilsvrc/prnmgseg').describe(PRNMGSEG52)}, BN folded, bf16, "
          f"batch {PRNMGSEG52_BATCH}: finite log-probs, rows sum to 1; launches {got}")
    del server
    # the f32 forward, card vs CPU: within 1e-5 of the outputs' scale, or
    # three times the change that moving the images by 1e-6 makes to the
    # CPU's own forward where that is larger (the deep mnist nets' f32
    # outputs moved by up to 5.1e-6 against an f64 forward on the CPU)
    for net, (opt, *_) in SEG_RECIPES.items():
        xs = seg_images(net, 1 if net == "ilsvrc/prnmgseg" else 2, seed=13)
        moved = xs * (1 + 1e-6 * np.random.default_rng(3).standard_normal(xs.shape,
                                                                          dtype=np.float32))
        y_gpu = Server(opt, seed=0, device="cuda", compute_dtype=torch.float32).predict(xs).cpu()
        cpu = Server(opt, seed=0, device="cpu", compute_dtype=torch.float32)
        y_cpu, y_moved = cpu.predict(xs), cpu.predict(moved)
        err, scale = (y_gpu - y_cpu).abs().max().item(), y_cpu.abs().max().item()
        own = (y_moved - y_cpu).abs().max().item()
        limit = max(1e-5 * scale, CIFAR_F32_OWN_FACTOR * own)
        check(err <= limit, f"{net} f32 forward: card vs CPU max abs err {err:.3g} (bound "
              f"{limit:.3g}; scale {scale:.3g}, the CPU's own under moved images {own:.3g})")
        phase("seg serve", f"{net} f32 forward on the card vs the plain CPU forward: max abs "
              f"err {err:.3g} (bound {limit:.3g}: 1e-5 x {scale:.4g}, or 3 x {own:.3g}, the "
              f"CPU's own change under images moved by 1e-6)")
    return launches


def seg_batch(net, images, seed):
    opt = SEG_RECIPES[net][0]
    spec = get_spec(net)
    return synthetic_batch(images, seed=seed, n_classes=spec.n_classes(opt),
                           shape=spec.image_shape, target_shape=spec.target_shape(opt))


def check_seg_train(name, rec) -> dict:
    """19: each net takes 4 bf16 steps through Trainer at its recipe's
    micro-batch and iterSize (prnmgseg's cut to 2) on one fixed batch at
    SEG_LR: the loss stays finite and falls, with the pinned launches
    per step through the predicted designs; one f32 step of each net on
    the card vs the same step on the CPU, with the CIFAR nets' bounds.
    Returns {net: Counter of its launches}."""
    launches = {net: Counter() for net in SEG_RECIPES}
    for net, (opt, micro, iters, _) in SEG_RECIPES.items():
        trainer = Trainer(opt, seed=0, device="cuda", compute_dtype=torch.bfloat16,
                          iter_size=iters)
        wd = trainer.net.train_rule(1, opt)["wd"]
        x, y = seg_batch(net, micro * iters, seed=1)
        want = {k: iters * n for k, n in SEG_PER_MICRO[net].items()}
        want_routes = {k: iters * n for k, n in predicted_routes(rec[net][1]).items()}
        kernels.reset_launches()
        losses = []
        for i in range(TRAIN_STEPS):
            prev, prev_routes = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
            m = trainer.step(x, y, SEG_LR[net], wd)
            got = {k: kernels.LAUNCHES[k] - prev[k] for k in prev}
            check(got == want, f"{net} step {i}: launches {got}, expected {want}")
            check(routes_since(prev_routes) == want_routes, f"{net} step {i}: conv and pool "
                  f"designs {routes_since(prev_routes)}, predicted {want_routes}")
            losses.append(float(m["loss"]))
        launches[net].update(kernels.LAUNCHES)
        check(all(np.isfinite(losses)), f"{net}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{net}: the loss did not fall: {losses}")
        cut = (f" (the recipe's iterSize {SEG_PRNMGSEG_RECIPE_ITERS} cut to {iters} for time)"
               if net == "ilsvrc/prnmgseg" else "")
        phase("seg train", f"{get_spec(net).describe(opt)}, bf16, {micro} x {iters}{cut} on "
              f"{name}: losses " + ", ".join(f"{v:.4f}" for v in losses)
              + f" at lr {SEG_LR[net]}, wd {wd}; launches per step {want}, designs as predicted")
        del trainer

    for net, (opt, *_) in SEG_RECIPES.items():
        micro = SEG_F32_MICRO[net]
        x2, y2 = seg_batch(net, 2 * micro, seed=2)
        moved = x2 * (1 + 1e-6 * np.random.default_rng(3).standard_normal(x2.shape,
                                                                          dtype=np.float32))
        wd = get_spec(net).train_rule(1, opt)["wd"]
        res = {}
        for key, dev, x in (("cuda", "cuda", x2), ("cpu", "cpu", x2), ("moved", "cpu", moved)):
            tr = Trainer(opt, seed=0, device=dev, compute_dtype=torch.float32, iter_size=2)
            before, _ = export_jax_tree(tr.model)
            m = tr.step(x, y2, 0.1, wd)
            res[key] = (float(m["loss"]), before, *export_jax_tree(tr.model))
        loss_err, upd, st = step_error(res)
        own = step_error({"cuda": res["moved"], "cpu": res["cpu"]})[1]
        limit = max(F32_STEP_PARAM_BOUND, CIFAR_F32_OWN_FACTOR * own)
        check(loss_err <= 1e-4 and upd <= limit and st <= F32_STEP_STATS_BOUND,
              f"{net} f32 step, card vs CPU: loss err {loss_err:.3g} (bound 1e-4), update err "
              f"{upd:.3g} (bound {limit:.3g}; the CPU's own under moved images {own:.3g}), "
              f"running stats err {st:.3g} (bound {F32_STEP_STATS_BOUND})")
        phase("seg train", f"{net} f32 step on the card vs the plain CPU step, {micro} x 2 at "
              f"lr 0.1: loss {res['cuda'][0]:.6f} vs {res['cpu'][0]:.6f}; parameter update err "
              f"{upd:.3g} of its L2 norm (bound {limit:.3g}; images moved by 1e-6 move the CPU's "
              f"own update by {own:.3g}); running stats err {st:.3g} of their scale (bound "
              f"{F32_STEP_STATS_BOUND})")
    return launches


def time_seg(name, rec) -> dict:
    """20: each net's bf16 serving forward (at its largest serving batch)
    and training step (its recipe's micro-batch x iterSize, prnmgseg's
    cut to 2), interleaved on the card's clock, with the card's busy
    share from a profile; then each kernel at the net's shapes beside its
    plain version and one PyTorch call, the median of 3 windows (as
    :func:`time_kernels`, without the pool's other design: the run's
    time). Returns {net: (ms, plain_ms, library_ms, simple_ms,
    design_times, bounds)}."""
    out = {}
    for k, (net, (opt, micro, iters, batches)) in enumerate(SEG_RECIPES.items()):
        serve, train = rec[net]
        server = Server(opt, seed=0, device="cuda", compute_dtype=torch.bfloat16)
        trainer = Trainer(opt, seed=0, device="cuda", compute_dtype=torch.bfloat16,
                          iter_size=iters)
        images = torch.from_numpy(seg_images(net, batches[-1], seed=12)).cuda()
        x, y = seg_batch(net, micro * iters, seed=4)
        xt, yt = torch.from_numpy(x).cuda().to(torch.bfloat16), torch.from_numpy(y).cuda()
        wd = trainer.net.train_rule(1, opt)["wd"]
        fns = {f"forward {batches[-1]}": lambda: server.predict(images),
               f"step {micro}x{iters}": lambda: trainer.step(xt, yt, SEG_LR[net], wd)}
        time_end_to_end("seg times", get_spec(net).describe(opt), name, fns,
                        {f"forward {batches[-1]}": batches[-1], f"step {micro}x{iters}": micro * iters})
        del server, trainer, images
        out[net] = (*time_kernels(net, serve, train, batches[-1], micro, iters,
                                  seed=1000 * (k + 1), alternatives=False, windows=3),
                    net_bounds(serve, train, batches[-1], micro, iters))
    return out


# 21-22: the run loop, `python -m mgtpu_torch.main`, driven in process
# through its main() (the function `python -m` runs) with a recipe's argv
RMG34_RECIPE = "scripts/ilsvrc/rnmg.sh"
SEG_RECIPE = "scripts/mnist-cluttered/unmg.sh"
# the recipes' epochs cut to 3 iterations, the synthetic sets to sizes
# whose test split (a quarter) fills one batch
RECIPE_CUT = ["-nEpochs", "2", "-epochSize", "3", "-stopAfter", "1"]
RMG34_SYNTH, SEG_SYNTH = 64, 128
ITER_LINE = re.compile(r"Epoch: \[(\d+)\]\[(\d+)/(\d+)\]\tRun:([0-9.]+)s lr:(\S+) "
                       r"Data:([0-9.]+)s (.*)")
EPOCH_LINE = re.compile(r"Epoch: \[(\d+)\]\[(TRAINING|TESTING)\] Total Time\(s\): ([0-9.]+) (.*)")


def recipe_argv(path):
    """The argv of a recipe under scripts/ (`soak_chain.recipe_argv`),
    each ${NAME:-default} at its default: -data synthetic."""
    return soak_chain.recipe_argv(Path(__file__).resolve().parent / path, env={})


def run_tool(name, *args) -> str:
    """``python -m mgtpu_torch.tools.<name> args``, as a user runs it, in
    a process of its own: its standard output (a non-zero exit fails)."""
    r = subprocess.run([sys.executable, "-m", f"mgtpu_torch.tools.{name}", *map(str, args)],
                       capture_output=True, text=True, timeout=300,
                       cwd=Path(__file__).resolve().parent)
    check(r.returncode == 0, f"mgtpu_torch.tools.{name} exited {r.returncode}: "
          f"{r.stdout[-1000:]}{r.stderr[-2000:]}")
    return r.stdout


def run_main(argv):
    """mgtpu_torch.main.main(argv) with the kernels' counts set to 0 just
    before: (the Session, its stdout, the launches it made, wall s)."""
    from mgtpu_torch.main import main as cli_main

    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sess = cli_main(argv)
    wall = time.perf_counter() - t0
    return sess, buf.getvalue(), dict(kernels.LAUNCHES), wall


def metric_lines(out, what):
    """The per-iteration and epoch lines of a run's output, each checked
    to hold finite numbers only: ({(epoch, it): (run s, data s, metrics)},
    {(epoch, TRAINING|TESTING): (total s, metrics)})."""
    iters, epochs = {}, {}
    for line in out.splitlines():
        m, e = ITER_LINE.search(line), EPOCH_LINE.search(line)
        if m:
            vals = dict(kv.split(":") for kv in m.group(7).split())
            iters[(int(m.group(1)), int(m.group(2)))] = (float(m.group(4)), float(m.group(6)),
                                                       {k: float(v) for k, v in vals.items()})
        elif e:
            vals = dict(kv.split(":") for kv in e.group(4).split())
            epochs[(int(e.group(1)), e.group(2))] = (float(e.group(3)),
                                                     {k: float(v) for k, v in vals.items()})
    for key, (*_, vals) in list(iters.items()) + list(epochs.items()):
        check(vals and all(np.isfinite(v) for v in vals.values()),
              f"{what} {key}: metrics {vals}")
    return iters, epochs


def expected_launches(per_micro, micros, per_forward, forwards) -> dict:
    return {k: micros * per_micro[k] + forwards * per_forward[k] for k in per_micro}


def check_recipe(name) -> dict:
    """21: R-MG-34's recipe (scripts/ilsvrc/rnmg.sh: 64 x 4 at 224 px, 10
    thread donkeys, full width) through mgtpu_torch.main in bf16: one
    epoch of 3 iterations and the test pass, each batch through the
    kernels (4 x PER_STEP a step, PER_FORWARD a test forward: the
    unfolded eval forward makes the serving forward's calls), the
    checkpoint read back equal to the live model and momentum; then a
    second call resumes from it and runs the ten-crop test pass. Prints
    the epoch's img/s, the Data: share of its wall time and the card's
    busy share of one step. Returns the launches of both calls."""
    from mgtpu_torch.data.prefetch import DonkeyPool, _exec_spec
    from mgtpu_torch.utils.bridge import export_momentum
    from mgtpu_torch.utils.checkpoint import load_checkpoint

    cache = tempfile.mkdtemp(prefix="chip_smoke_rmg34_")
    recipe = recipe_argv(RMG34_RECIPE)
    argv = recipe + ["-dtype", "bfloat16", *RECIPE_CUT, "-synthSize", str(RMG34_SYNTH),
                     "-cache", cache]
    sess, out, got, wall = run_main(argv)
    opt = sess.opt
    micro, iters, n = opt.batchSize, opt.iterSize, opt.epochSize
    n_test = -(-sess.loaders["test"].size() // micro)
    want = expected_launches(PER_STEP, n * iters, PER_FORWARD, n_test)
    check(got == want, f"{RMG34_RECIPE}: launches {got}, expected {want} ({n} steps of "
          f"{iters} x {micro}, {n_test} test forwards)")
    lines, epochs = metric_lines(out, RMG34_RECIPE)
    check(sorted(lines) == [(1, i + 1) for i in range(n)] and (1, "TESTING") in epochs,
          f"{RMG34_RECIPE}: lines {sorted(lines)}, epochs {sorted(epochs)}")
    train_s = epochs[(1, "TRAINING")][0]
    data_s = sum(d for _, d, _ in lines.values())
    phase("recipe", f"{RMG34_RECIPE} ({' '.join(argv[len(recipe):])}): R-MG-{opt.depth} "
          f"{micro} x {iters} bf16 on {name}, {opt.nDonkeys} {opt.donkeyMode} donkeys, in "
          f"{wall:.1f} s: " + "; ".join(
              f"it {i}: Run {r:.3f} s Data {d:.3f} s loss {v['loss']:.4f}"
              for (_, i), (r, d, v) in sorted(lines.items())))
    phase("recipe", f"epoch 1: {train_s:.2f} s = {n * micro * iters / train_s:.1f} img/s, "
          f"Data: {data_s:.2f} s ({data_s / train_s:.0%} of the epoch's wall time); test "
          f"{sess.loaders['test'].size()} images in {epochs[(1, 'TESTING')][0]:.2f} s, "
          f"{fmt(epochs[(1, 'TESTING')][1])}; launches {got} = {n} x {iters} x PER_STEP + "
          f"{n_test} x PER_FORWARD")

    path = Path(opt.save) / "model_1.ckpt"
    blob = load_checkpoint(str(path))
    params, stats = export_jax_tree(sess.model)
    for key, live in (("params", params), ("stats", stats),
                      ("opt_state", export_momentum(sess.model, sess.opt_state))):
        a, b = flat(blob[key]), flat(live)
        check(len(a) == len(b) and all(torch.equal(x, torch.from_numpy(y)) for x, y in zip(a, b)),
              f"{path}: {key} differ from the live model's")
    phase("recipe", f"{path.name} ({path.stat().st_size / 1e6:.1f} MB) read back: parameters, "
          f"BN stats and momentum equal the live model's, epoch {blob['epoch']}, meta "
          f"{blob['meta']}")

    # the data layer alone: the recipe's donkeys making nDonkeys batches at
    # once, against the step's rate (it 3's Run: above)
    pool = DonkeyPool(opt.nDonkeys, mode=opt.donkeyMode, opt=opt, loaders=sess.loaders)
    t0 = time.perf_counter()
    try:
        made = sum(1 for _ in pool.imap_specs(("gen", "train", micro, 9, 1000 * i, iters)
                                              for i in range(opt.nDonkeys)))
    finally:
        pool.shutdown()
    rate = made * micro * iters / (time.perf_counter() - t0)
    phase("recipe", f"the data layer alone: {opt.nDonkeys} {opt.donkeyMode} donkeys made {made} "
          f"batches of {micro} x {iters} at {rate:.1f} img/s; the step's rate at it {n}: "
          f"{micro * iters / lines[(1, n)][0]:.1f} img/s")

    # the card's busy share of one more step on a batch of this recipe
    seed = opt.manualSeed * 1_000_003 + 7
    batch = sess.to_device(_exec_spec(sess.loaders, ("gen", "train", micro, 1, seed, iters)))
    lr = sess.lr_wd()
    busy = device_busy_ms(lambda: float(sess.train_step(sess.opt_state, batch, lr["lr"],
                                                        lr["wd"])["loss"]))
    phase("recipe", f"one {micro} x {iters} step, profiled: " + (
        "no device time in the trace (not measured)" if busy is None else
        f"card busy {busy[0]:.1f} ms of {busy[1]:.1f} ms wall ({busy[0] / busy[1]:.0%})"))
    del sess, batch

    argv2 = [a for a in recipe if a != "-train"] + [
        "-dtype", "bfloat16", "-nEpochs", "2", "-epochNumber", "2", "-retrain", str(path),
        "-tenCrop", "-synthSize", str(RMG34_SYNTH), "-cache", cache]
    sess, out2, got2, wall2 = run_main(argv2)
    want2 = expected_launches(PER_STEP, 0, PER_FORWARD, n_test)
    check(f"=> resumed from {path} (epoch 1)" in out2, f"no resume line in {out2[-500:]}")
    check(got2 == want2, f"ten-crop test: launches {got2}, expected {want2}")
    lines2, epochs2 = metric_lines(out2, "ten-crop test")
    check(not lines2 and list(epochs2) == [(2, "TESTING")], f"ten-crop run: {sorted(epochs2)}")
    phase("recipe", f"resumed from {path.name} with -tenCrop -test, in {wall2:.1f} s: "
          f"{sess.loaders['test'].size()} images x 10 crops in {epochs2[(2, 'TESTING')][0]:.2f} "
          f"s, {fmt(epochs2[(2, 'TESTING')][1])}; launches {got2}")
    del sess
    shutil.rmtree(cache)
    return {k: got[k] + got2[k] for k in KERNELS}


def check_harness_chain(name) -> dict:
    """22: mnist-cluttered/unmg's recipe (scripts/mnist-cluttered/unmg.sh,
    mnist-seg, 64 a step, f32) trained 3 iterations and tested through
    mgtpu_torch.main, each batch through the kernels; then
    mnist-cluttered/mnist-test -retrain on its checkpoint: the same test
    loss and meanIU within 1e-5, its launches, and testOutput_1.h5 read
    back through mgtpu_torch.utils.h5: NHWC f32 predictions in [0, 1] of
    every test sample; then the port's seg_metrics and render_predictions
    on that file (mean IU and Acc held to the per-class counts of
    utils.metrics.seg_mean_iu_mean_acc on the same arrays; the panel's
    size). Returns the launches."""
    from mgtpu_torch.utils.metrics import seg_mean_iu_mean_acc

    t0 = time.perf_counter()
    net = "mnist-cluttered/unmg"
    cache = tempfile.mkdtemp(prefix="chip_smoke_unmg_")
    recipe = recipe_argv(SEG_RECIPE)
    sess, out, got, wall = run_main(recipe + [*RECIPE_CUT, "-synthSize", str(SEG_SYNTH),
                                              "-cache", cache])
    opt = sess.opt
    n_test = -(-sess.loaders["test"].size() // opt.batchSize)
    want = expected_launches(SEG_PER_MICRO[net], opt.epochSize, SEG_PER_FORWARD[net], n_test)
    check(got == want, f"{SEG_RECIPE}: launches {got}, expected {want}")
    lines, epochs = metric_lines(out, SEG_RECIPE)
    test = epochs[(1, "TESTING")][1]
    phase("harness", f"{SEG_RECIPE} cut to {opt.epochSize} iterations, f32 on {name}, in "
          f"{wall:.1f} s: losses " + ", ".join(f"{v['loss']:.4f}" for _, _, v in lines.values())
          + f"; test {fmt(test)}; launches {got}")
    ckpt = Path(opt.save) / "model_1.ckpt"
    del sess

    argv = [a for a in recipe if a not in ("-train", "-netType", net)] + [
        "-netType", "mnist-cluttered/mnist-test", "-nEpochs", "1", "-retrain", str(ckpt),
        "-synthSize", str(SEG_SYNTH), "-cache", cache]
    sess, out2, got2, wall2 = run_main(argv)
    want2 = expected_launches(SEG_PER_MICRO[net], 0, SEG_PER_FORWARD[net], n_test)
    check(got2 == want2, f"mnist-test: launches {got2}, expected {want2}")
    _, epochs2 = metric_lines(out2, "mnist-test")
    again = epochs2[(1, "TESTING")][1]
    check(all(abs(again[k] - test[k]) <= 1e-5 for k in ("avg.loss", "avg.meanIU")),
          f"mnist-test {fmt(again)} vs the training run's test {fmt(test)}")
    dump = Path(sess.opt.save) / "testOutput_1.h5"
    check(f"stored outputs -> {dump}" in out2, f"mnist-test: no dump line in {out2[-500:]}")
    loader = sess.loaders["test"]
    with h5.File(dump, "r") as f:
        check(f.keys() == ["prediction"], f"{dump.name}: datasets {f.keys()}")
        pred = np.asarray(f["prediction"])
    check(pred.shape == (loader.size(), 64, 64, 10) and pred.dtype == np.float32,
          f"prediction {pred.shape} {pred.dtype}, expected NHWC (N, 64, 64, 10) f32")
    check(bool(np.isfinite(pred).all()) and 0.0 <= pred.min() and pred.max() <= 1.0,
          f"prediction values in [{pred.min()}, {pred.max()}], expected [0, 1]")
    phase("harness", f"mnist-test -retrain {ckpt.name} in {wall2:.1f} s: {fmt(again)} "
          f"(the training run's test: {fmt(test)}); launches {got2}; {dump.name} "
          f"({dump.stat().st_size} bytes) read back through mgtpu_torch.utils.h5: NHWC f32 "
          f"prediction {pred.shape} in [{pred.min():.4f}, {pred.max():.4f}]")
    # the offline tools on the dump, against the test split the run read
    targets = Path(cache) / "mnist_segmentation.npz"
    np.savez_compressed(targets, test_inputs=loader.inputs, test_targets=loader.targets)
    report = run_tool("seg_metrics", dump, "--targets", targets)
    got_iu, got_acc = (float(re.search(rf"mean {k}: ([0-9.]+)", report).group(1))
                       for k in ("IU", "Acc"))
    tp, fp, fn = (c.double() for c in seg_mean_iu_mean_acc(
        torch.from_numpy(pred), torch.from_numpy(loader.targets.astype(np.float32))))
    iu = float((tp / (tp + fp + fn).clamp_min(1e-12)).mean())
    acc = float((tp / (tp + fp).clamp_min(1e-12)).mean())
    check(abs(got_iu - iu) <= 1e-6 and abs(got_acc - acc) <= 1e-6, f"seg_metrics: mean IU "
          f"{got_iu}, Acc {got_acc}; the per-class counts give {iu:.6f}, {acc:.6f}")
    panel = Path(cache) / "viz" / "predictions.png"
    drawn = run_tool("render_predictions", dump, "--targets", targets, "--out", panel)
    from PIL import Image

    with Image.open(panel) as im:
        size = im.size
    rows = min(8, loader.size())  # 3 cells of 64 px a row, 2 px apart, 3x upscaled
    check(size == (3 * (3 * 64 + 4 * 2), 3 * (rows * 64 + (rows + 1) * 2)),
          f"render_predictions: a {size} panel for {rows} rows")
    phase("harness", f"mgtpu_torch.tools.seg_metrics on {dump.name}: "
          + "; ".join(report.split("\n")[:2]) + f" (the per-class counts: {iu:.6f}, {acc:.6f}); "
          f"render_predictions: {drawn.strip()} ({size[0]}x{size[1]} px)")
    launches = {k: got[k] + got2[k] for k in KERNELS}
    del sess
    shutil.rmtree(cache)
    phase("harness", f"phase 22 took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------- int8 serving (phases 23-26)

# each net served under int8 (BN folded, then quantized, as Server does) at
# its serving batches: R-MG-34, cifar/prnmg and unmg at their recipes
I8_SERVE = {"ilsvrc/rnmg": (RMG34, (1, 128)),
            "cifar/prnmg": (cifar_opts("cifar/prnmg"), (CIFAR_SERVE_BATCH,)),
            "mnist-cluttered/unmg": (SEG_RECIPES["mnist-cluttered/unmg"][0], (64,))}
# launches per int8 serving forward with static scales: one conv_i8 per
# quantized conv part (the 3x3 down, same and up parts, the 1x1 shortcuts
# and heads, the 7x7 and 3x3 stems) and one quant_i8 (the group design) a
# layer: a stem's images, an MgConv's or a residual stage's parts, a conv
# outside a multigrid layer (R-MG-34: the stem and 32 stages, of 7, 4 and
# 1 parts; cifar/prnmg 77 parts in 15, unmg 40 in 8); the pools as in the
# float forward; no 3x3 conv kernel (i8_pins: dynamic scales add an
# absmax launch of quant_i8 a layer)
I8_PER_FORWARD = {"ilsvrc/rnmg": launch_counts(0, 0, 46, 0, 155, 33),
                  "cifar/prnmg": launch_counts(0, 0, 32, 0, 77, 15),
                  "mnist-cluttered/unmg": launch_counts(0, 0, 16, 0, 40, 8)}
# conv_i8's designs per int8 forward (cuda_conv_i8._route): sm90 takes
# the 3x3/s1 parts whose channel counts and weight offsets are multiples
# of 16; stem the 7x7/2 and 3x3 stems on 3 and 1 channels; 1x1 the 1x1
# shortcuts and heads on multiples of 16 channels (cifar/prnmg's); simple
# the rest (unmg's 1x1 heads on 10 channels)
I8_ROUTES = {"ilsvrc/rnmg": {"sm90": 152, "stem": 3, "1x1": 0, "simple": 0},
             "cifar/prnmg": {"sm90": 66, "stem": 3, "1x1": 8, "simple": 0},
             "mnist-cluttered/unmg": {"sm90": 30, "stem": 3, "1x1": 0, "simple": 7}}
# calibration batches of the static scales (Server's, CALIB_BATCH images each)
I8_CALIB = 2
KERNELS_I8 = {"conv_i8": dict(route="cuda", source="mgtpu_torch/csrc/conv_i8.cu",
                              replaces="mgtpu/ops/quant.py:139",
                              design_sources={"sm90": "mgtpu_torch/csrc/conv_i8.cu",
                                              "stem": "mgtpu_torch/csrc/conv_i8_stem.cu",
                                              "1x1": "mgtpu_torch/csrc/conv_i8_1x1.cu",
                                              "simple": "mgtpu_torch/csrc/conv_i8.cu"}),
              "quant_i8": dict(route="cuda", source="mgtpu_torch/csrc/quant_i8.cu",
                               replaces="mgtpu/ops/quant.py:60")}
# the H100 SXM's published dense int8 tensor-core peak (NVIDIA's data sheet)
PEAK_INT8_OPS = 1979e12
# the run loop under -int8: tests/test_int8.py's contract (a float run's
# checkpoint re-tested under int8, loss within 5%), f32 as there
I8_RUN = ["-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-data", "synthetic",
          "-synthSize", "64", "-batchSize", "16", "-imageSize", "36", "-imageCrop", "32",
          "-nGPU", "1", "-nDonkeys", "0"]
I8_LOSS_RTOL = 0.05
# conv_i8's epilogue variants phase 23 holds each design to: (output
# dtype, operands): the int32 sums; the dequant alone; with the part sum,
# the bias and the ReLU; with the bias alone
I8_VARIANTS = [(torch.int32, ()), (torch.float32, ("sx",)), (torch.bfloat16, ("sx",)),
               (torch.float32, ("sx", "y_in", "bias", "relu")),
               (torch.bfloat16, ("sx", "y_in", "bias", "relu")), (torch.bfloat16, ("sx", "bias"))]


def i8_pins(net, dynamic=False) -> dict:
    """The launches of one int8 forward of ``net``: I8_PER_FORWARD, with
    two quant_i8 launches a layer under dynamic scales."""
    pins = dict(I8_PER_FORWARD[net])
    pins["quant_i8"] *= 2 if dynamic else 1
    return pins


def i8_routes(shapes) -> dict:
    """{design: launches} that cuda_conv_i8._route gives an int8 forward's
    recorded conv_i8 calls: stand-in CPU tensors of their shapes (the
    weight a slice of its conv's weight, with its packed copy; on the
    card the quantized parts and the buffers are 16-byte aligned as
    these are)."""
    got = dict.fromkeys(cuda_conv_i8.DESIGNS, 0)
    for key, count in shapes.items():
        h, w, ci, co, k, stride, pad, ci_total, ofs = key[:9]
        x8 = torch.empty((1, h, w, ci), dtype=torch.int8)
        w8 = torch.empty((k, k, ci_total, co), dtype=torch.int8)[:, :, ofs:ofs + ci]
        wk = torch.empty((co, k * k * ci_total), dtype=torch.int8)
        got[cuda_conv_i8._route(x8, w8, stride, pad, wk)] += count
    return got


def int8_layers(model) -> int:
    """The quantize calls (quant_i8_group) of one int8 forward of
    ``model``: one a multigrid layer (a stem's images, an MgConv's parts,
    each stage of an MgResidual) and one a quantized conv outside one
    (the 1x1 shortcuts, the heads, the plain nets' convs)."""
    from mgtpu_torch.ops.mg import MgConv, MgConvInput, MgResidual, MgStem7x7

    calls, grouped = 0, set()
    for m in model.modules():
        stages = ([m.convs] if isinstance(m, (MgConv, MgConvInput, MgStem7x7))
                  else [m.stage1, m.stage2] if isinstance(m, MgResidual) else [])
        calls += len(stages)
        grouped.update(id(layer.conv) for stage in stages for layer in stage)
    return calls + sum(getattr(m, "quantized", False) and id(m) not in grouped
                       for m in model.modules())


def record_i8() -> dict:
    """{net: the int8 serving forward's kernel calls}, recorded on the CPU
    and held to the pins (the calls, and conv_i8's predicted designs)."""
    rec = {}
    for net, (opt, _) in I8_SERVE.items():
        rec[net] = record_kernel_shapes(False, opt, int8=True)
        got = {k: sum(c.values()) for k, c in rec[net].items()}
        check(got == I8_PER_FORWARD[net], f"{net}: the CPU int8 forward made kernel calls "
              f"{got}, expected {I8_PER_FORWARD[net]}")
        routes = i8_routes(rec[net]["conv_i8"])
        check(routes == I8_ROUTES[net], f"{net}: conv_i8 designs {routes}, pinned "
              f"{I8_ROUTES[net]}")
    return rec


def i8_work(key, batch, itemsize=2, pads=None):
    """(operations, bytes) of one conv_i8 launch at a recorded shape and
    ``batch``, its output in ``itemsize`` bytes: multiply-adds (2 each)
    on the taps inside x; x and w read once (int8), sx and v (f32)
    read, the part sum y_in and the bias read where the launch takes them,
    and y written once. ``pads`` (pad_top, pad_bottom): a halo-mode
    launch, whose x holds the key's H rows with its halo rows."""
    h, w, ci, co, k, stride, pad = key[:7]
    has_in, has_bias = key[9:11]
    pt, pb = (pad, pad) if pads is None else pads
    oh, ow = (cuda_conv_i8.out_size(h, k, stride, pt, pb),
              cuda_conv_i8.out_size(w, k, stride, pad))

    def taps(n, m, before):  # in-x taps summed over the m outputs along a side of n
        return sum(sum(0 <= o * stride - before + t < n for t in range(k)) for o in range(m))

    out = batch * oh * ow * co
    nbytes = (batch * h * w * ci + k * k * ci * co + 4 + 4 * co + 4 * co * has_bias
              + itemsize * out * (1 + has_in))
    return 2 * batch * taps(h, oh, pt) * taps(w, ow, pad) * ci * co, nbytes


def i8_bounds(shapes, batch):
    """(operations, bytes, bound ms, bound_by) of a forward's conv_i8
    launches at ``batch``: each launch's larger of operations over the
    int8 peak and bytes over HBM's, summed."""
    ops = nbytes = ms = ops_ms = 0
    for key, count in shapes.items():
        f, b = i8_work(key, batch)
        t_ops, t_bytes = f / PEAK_INT8_OPS * 1e3, b / PEAK_HBM_BYTES * 1e3
        ops, nbytes, ms = ops + count * f, nbytes + count * b, ms + count * max(t_ops, t_bytes)
        ops_ms += count * t_ops * (t_ops > t_bytes)
    return ops, nbytes, ms, "operations" if ms and 2 * ops_ms >= ms else "bytes"


def quant_dtype(key):
    """The dtype the bf16 int8 forward quantizes a recorded part in: the
    stems' 3-channel images are f32, every other part bf16."""
    return torch.float32 if key[2] == 3 else torch.bfloat16


def quant_bytes(keys, batch):
    """Bytes one quant_i8 group launch must move: each member's input
    read once, its int8 output (upsampled for an "up" part) written
    once."""
    return sum(batch * c * (h * w * quant_dtype(key).itemsize + oh * ow)
               for key in keys for h, w, c, oh, ow in (key,))


# values on the quantize's edges, in units of the scale: ties (to even),
# +-0, past +-127 steps, +-inf, NaN (0 on both sides)
QUANT_SPECIALS = (0.5, 1.5, 2.5, -2.5, 0.0, -0.0, 126.5, -127.5, 1e4, -1e4, float("inf"),
                  float("-inf"), float("nan"))


def quant_members(keys, batch, seed, static, dtypes=None, misalign=()):
    """One quant_i8_group call's members [(x, sx, up)] on the card at
    recorded member shapes ``keys`` and ``batch``: values 40 * N(0, 1)
    led by QUANT_SPECIALS (without inf and NaN for dynamic scales, which
    would make the scale inf or NaN and every value 0), in the forward's
    dtype (quant_dtype) or ``dtypes``; static scales views of one vector,
    as a conv's ``sx`` slots are; the members in ``misalign`` 4 bytes
    off a 16-byte boundary."""
    sxv = torch.linspace(0.5, 1.5, len(keys), device="cuda")
    specials = torch.tensor(QUANT_SPECIALS if static else QUANT_SPECIALS[:-3], device="cuda")
    members = []
    for j, key in enumerate(keys):
        h, w, c, oh, ow = key
        g = torch.Generator(device="cuda").manual_seed(seed + j)
        x = 40 * torch.randn((batch, h, w, c), generator=g, device="cuda")
        k = min(x.numel(), specials.numel())
        x.view(-1)[:k] = specials[:k]
        x = x.to(quant_dtype(key) if dtypes is None else dtypes[j])
        members.append((misaligned(x) if j in misalign else x, sxv[j] if static else None,
                        None if (oh, ow) == (h, w) else (oh, ow)))
    return members


# quant_i8_group tables beyond the forwards': odd C, a 1x1 map upsampled,
# odd crops, f32 and bf16 in one launch, members off a 16-byte boundary;
# and MAX_MEMBERS + 1 members (two launches a pass), the last misaligned
QUANT_EDGE_GROUPS = [
    ([(7, 7, 3, 7, 7), (5, 6, 24, 9, 12), (4, 4, 5, 8, 8), (1, 1, 64, 2, 2), (3, 5, 16, 5, 10),
      (9, 9, 17, 9, 9)], (torch.float32, torch.bfloat16) * 3, (1, 3)),
    ([(4, 4, 16, 8, 8), (2, 3, 32, 4, 6)] * (quant.MAX_MEMBERS // 2) + [(6, 6, 48, 6, 6)], None,
     (quant.MAX_MEMBERS,))]


def check_quant_group(members, what, stats) -> None:
    """quant_i8_group on ``members`` vs quant_i8_group_plain, int8 values
    and scales bit for bit, in the launches the group design takes
    (MAX_MEMBERS a launch, twice with dynamic scales); each member also
    through the per-part design (quant._part_forward) against it."""
    before, routes = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
    got = quant.quant_i8_group(members)
    n_launch = kernels.LAUNCHES["quant_i8"] - before["quant_i8"]
    n_group = routes_since(routes)[("quant_i8", "group")]
    ref = quant.quant_i8_group_plain(members)
    chunks = -(-len(members) // quant.MAX_MEMBERS)
    dynamic = sum(sx is None for _, sx, _ in members)
    want = chunks + -(-dynamic // quant.MAX_MEMBERS)
    check(n_launch == n_group == want, f"{what}: {n_launch} quant_i8 launches ({n_group} group), "
          f"expected {want}")
    for j, ((x8, s), (r8, rs), (x, sx, up)) in enumerate(zip(got, ref, members)):
        p8, ps = quant._part_forward(x, sx, up)
        ok = (torch.equal(x8, r8) and pool_equal(s.reshape(()), rs.reshape(()))[0]
              and torch.equal(p8, r8) and pool_equal(ps.reshape(()), rs.reshape(()))[0])
        stats["members"] += 1
        stats["elements"] += x8.numel()
        if not ok:
            stats["bad"] += 1
            check(False, f"{what}: member {j} {tuple(x.shape)} {x.dtype} up {up} "
                  f"{'static' if sx is not None else 'dynamic'}: group or per-part design "
                  f"differs from quant_i8_group_plain (values equal: group "
                  f"{torch.equal(x8, r8)}, part {torch.equal(p8, r8)}; scales {float(s)} "
                  f"{float(ps)} {float(rs)})")
    stats["tables"] += 1


def check_quant_groups(i8_rec) -> Counter:
    """23: the quantizer's group design vs quant_i8_group_plain at every
    member table the int8 forwards of I8_SERVE give it (each net's
    recorded groups at its serving batches) and at QUANT_EDGE_GROUPS,
    static and dynamic scales (check_quant_group)."""
    stats = Counter()
    cases = sorted({(keys, batch) for net, (_, batches) in I8_SERVE.items()
                    for keys in i8_rec[net]["quant_i8"] for batch in batches})
    for i, (keys, batch) in enumerate(cases):
        for static in (True, False):
            check_quant_group(quant_members(keys, batch, 700 + 20 * i, static),
                              f"quant_i8 group {batch} x {keys}", stats)
    for i, (keys, dtypes, off) in enumerate(QUANT_EDGE_GROUPS):
        for static in (True, False):
            check_quant_group(quant_members(keys, 3, 500 + 20 * i, static, dtypes, off),
                              f"quant_i8 edge group {i}", stats)
    torch.cuda.synchronize()
    stats["cases"] = len(cases)
    return stats


def i8_operands(key, batch, seed):
    """Full-range int8 x (batch, H, W, Ci), the weight slice the key
    names (a view of a (k, k, Ci total, Co) weight at its input channel)
    with that weight's packed copy, a dequant vector v (Co,) f32 and an
    activation scale sx (0-d f32), on the card."""
    h, w, ci, co, k, _, _, ci_total, ofs = key[:9]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x8 = torch.randint(-127, 128, (batch, h, w, ci), generator=g, device="cuda").to(torch.int8)
    wide = torch.randint(-127, 128, (k, k, ci_total, co), generator=g, device="cuda").to(
        torch.int8)
    v = 1e-4 + 1e-3 * torch.rand(co, generator=g, device="cuda")
    sx = 0.5 + torch.rand((), generator=g, device="cuda")
    return x8, wide[:, :, ofs:ofs + ci], cuda_conv_i8.pack_weight(wide), v, sx


def check_conv_i8(cases, max_err) -> Counter:
    """23: conv_i8 vs conv_i8_plain at each (recorded shape, batch),
    through the design _route picks and, where that is not simple,
    through the simple design too; the batch-1 cases also with x off a
    16-byte boundary (the design _route picks for it: stem takes any
    offset; sm90 and 1x1 parts go to simple). Each epilogue variant of
    I8_VARIANTS: the int32 sums, and the f32 and bf16 epilogues equal the
    plain version's bit for bit (the plain conv in float64 on the card is
    exact; the epilogue rounds as torch does). Returns the cases by
    design."""
    designs = Counter()
    for i, (key, batch) in enumerate(sorted(cases)):
        x8, w8, wk, v, sx = i8_operands(key, batch, seed=i)
        stride, pad = key[5], key[6]
        acc = cuda_conv_i8.conv_i8_plain(x8, w8, stride, pad)
        g = torch.Generator(device="cuda").manual_seed(10_000 + i)
        bias = torch.randn(w8.shape[3], generator=g, device="cuda")
        y0 = torch.randn(acc.shape, generator=g, device="cuda")
        route = cuda_conv_i8._route(x8, w8, stride, pad, wk)
        runs = [(route, x8, lambda xi, **kw: cuda_conv_i8.conv_i8(xi, w8, stride, pad, wk=wk,
                                                                  **kw))]
        if route != "simple":
            runs.append(("simple", x8, lambda xi, **kw: cuda_conv_i8._simple_forward(
                xi, w8, stride, pad, **kw)))
        if batch == 1:
            xm = misaligned(x8)
            runs.append((cuda_conv_i8._route(xm, w8, stride, pad, wk), xm, runs[0][2]))
        for design, xi, fn in runs:
            for dt, ops in I8_VARIANTS:
                kw = {} if dt == torch.int32 else {"v": v, "dtype": dt, "sx": sx}
                if "bias" in ops:
                    kw["bias"] = bias
                if "relu" in ops:
                    kw["relu"] = True
                want = acc if dt == torch.int32 else cuda_conv_i8.epilogue_plain(
                    acc, v, dt, sx=sx, y_in=y0.to(dt) if "y_in" in ops else None,
                    bias=kw.get("bias"), relu=kw.get("relu", False))
                if "y_in" in ops:
                    kw["y_in"] = y0.to(dt)
                before = dict(kernels.ROUTES)
                y = fn(xi, **kw)
                check(routes_since(before) == {r: int(r == ("conv_i8", design))
                                               for r in kernels.ROUTES},
                      f"conv_i8 {batch}x{key}: designs {routes_since(before)}, expected {design}")
                err = (y.double() - want.double()).abs().max().item()
                check(y.dtype == dt and y.shape == want.shape and torch.equal(y, want),
                      f"conv_i8 {batch}x{key} -> {dt} {ops} through {design}, x aligned="
                      f"{xi is x8}: max abs err {err:.3g} against the plain version")
                max_err["conv_i8"] = max(max_err["conv_i8"], err)
                designs[design] += 1
    torch.cuda.synchronize()
    return designs


@contextlib.contextmanager
def checked_quant(stats):
    """Within: every quant.quant_i8_group call (the layers' quantizer, a
    layer's parts or a single conv's input) also runs its plain version,
    quant_i8_group_plain (quantize_act's torch ops and the nearest
    upsample), on the same inputs on the card, and ``stats`` counts the
    calls, the parts, the elements, and those whose int8 value or scale
    differ, and keeps the largest difference of an int8 value."""
    original = quant.quant_i8_group

    def fn(members):
        out = original(members)
        stats["calls"] += 1
        for (x8, s), (ref8, ref_s), (_, sx, _) in zip(out, quant.quant_i8_group_plain(members),
                                                      members):
            stats["parts"] += 1
            stats["dynamic"] += sx is None
            stats["elements"] += x8.numel()
            same = x8.shape == ref8.shape
            stats["bad_values"] += int((x8 != ref8).sum()) if same else x8.numel()
            if same and x8.numel():
                diff = int((x8.int() - ref8.int()).abs().max())
                stats["max_abs_err"] = max(stats["max_abs_err"], diff)
            stats["bad_scales"] += int(not torch.equal(s.reshape(()), ref_s.reshape(())))
        return out

    quant.quant_i8_group = fn
    try:
        yield stats
    finally:
        quant.quant_i8_group = original


def i8_images(net, batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, *get_spec(net).image_shape),
                                                       dtype=np.float32)


def check_i8_serve(name) -> tuple[dict, Counter]:
    """24: each net served under int8 (BN folded, quantized, bf16) through
    Server at its serving batches, with static scales (I8_CALIB batches)
    and, R-MG-34, dynamic ones: outputs checked, the pinned launches and
    conv_i8 designs per forward; a second forward in which every quantizer
    call is held to its plain torch ops on the same activation on the card
    (checked_quant: int8 values and scales equal); its distance from the
    bf16 forward of the same weights (and, but R-MG-34, one median time
    of each at the largest batch); the f32 int8 forward on the card vs
    the plain CPU int8 forward (the same frozen scales) within 1e-5 of the
    outputs' scale: conv_i8 and quant_i8 are exact and the layers around
    them (pools, BN-free heads) compute the same f32 values on both sides,
    so a quantize step that flips on one side only (e.g. a divide done as
    a multiply by the reciprocal) shows far above it. Returns ({net:
    Counter of the serving forwards' launches}, the quantizer checks)."""
    launches = {net: Counter() for net in I8_SERVE}
    qstats = Counter()
    for net, (opt, batches) in I8_SERVE.items():
        float_server = Server(opt, seed=0, device="cuda", compute_dtype=torch.bfloat16)
        for calib in (I8_CALIB, 0) if net == "ilsvrc/rnmg" else (I8_CALIB,):
            mode = f"static ({calib} batches)" if calib else "dynamic"
            pins = i8_pins(net, dynamic=not calib)
            routes_pin = {("conv_i8", d): n for d, n in I8_ROUTES[net].items()}
            t0 = time.perf_counter()
            server = Server(opt, seed=0, device="cuda", compute_dtype=torch.bfloat16, int8=True,
                            int8_calib=calib)
            built = time.perf_counter() - t0
            for batch in batches:
                x = i8_images(net, batch, seed=11)
                kernels.reset_launches()
                y = server.predict(x)
                got, routes = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
                torch.cuda.synchronize()
                check(got == pins, f"{net} int8 {mode} batch {batch}: launches {got}, expected "
                      f"{pins}")
                got_routes = {r: n for r, n in routes.items() if r[0] == "conv_i8"}
                check(got_routes == routes_pin, f"{net} int8 {mode} batch {batch}: conv_i8 "
                      f"designs {got_routes}, pinned {routes_pin}")
                output_checks(f"{net} int8 {mode} batch {batch}", y, batch, opt)
                launches[net].update(got)
                before = Counter(qstats)
                with checked_quant(qstats):
                    y_again = server.predict(x)
                torch.cuda.synchronize()
                check(torch.equal(y_again, y), f"{net} int8 {mode} batch {batch}: a second "
                      f"forward differs from the first")
                y_bf16 = float_server.predict(x)
                d = (y - y_bf16).abs().max().item()
                agree = (f"; top-1 agrees on {int((y.argmax(-1) == y_bf16.argmax(-1)).sum())}/"
                         f"{batch}" if y.dim() == 2 else "")
                q = qstats - before
                phase("i8 serve", f"{get_spec(net).describe(opt)} int8 {mode}, BN folded, bf16, "
                      f"batch {batch} on {name} (built in {built:.1f} s): {tuple(y.shape)} "
                      f"finite f32 outputs in range; launches {got}, conv_i8 designs "
                      f"{I8_ROUTES[net]}; quantizer vs its plain torch ops at the forward's "
                      f"activations: {q['calls']} calls of {q['parts']} parts, {q['elements']} "
                      f"int8 values, "
                      f"{q['bad_values']} differ, {q['bad_scales']} scales differ; against the "
                      f"bf16 forward of the same weights: max abs {d:.4g} (scale "
                      f"{y_bf16.abs().max().item():.4g}){agree}")
            if net != "ilsvrc/rnmg":  # one median each (R-MG-34's times: phase 26)
                images = torch.from_numpy(i8_images(net, batches[-1], seed=12)).cuda()
                (t8, sp8), (t16, sp16) = interleaved_ms(
                    [lambda: server.predict(images), lambda: float_server.predict(images)])
                phase("i8 serve", f"{net} int8 {mode} forward at batch {batches[-1]}: {t8:.3f} "
                      f"ms (median of 5 interleaved windows, spread {sp8:.1%}), the bf16 "
                      f"forward {t16:.3f} ms (spread {sp16:.1%}) on {name}")
            xs = i8_images(net, 2, seed=13)
            gpu = Server(opt, seed=0, device="cuda", compute_dtype=torch.float32, int8=True,
                         int8_calib=calib)
            cpu = Server(opt, seed=0, device="cpu", compute_dtype=torch.float32, int8=True)
            for m_cpu, m_gpu in zip(cpu.model.modules(), gpu.model.modules()):
                if getattr(m_gpu, "quantized", False) and m_gpu.sx is not None:
                    m_cpu.sx = m_gpu.sx.cpu()  # the card's frozen scales
            with checked_quant(qstats):
                y_gpu = gpu.predict(xs).cpu()
            y_cpu = cpu.predict(xs)
            err, scale = (y_gpu - y_cpu).abs().max().item(), y_cpu.abs().max().item()
            limit = 1e-5 * scale
            check(err <= limit, f"{net} int8 {mode} f32 forward: card vs CPU max abs err "
                  f"{err:.3g} (bound {limit:.3g}: 1e-5 x the scale {scale:.4g})")
            phase("i8 serve", f"{net} int8 {mode} f32 forward on the card vs the plain CPU "
                  f"forward: max abs err {err:.3g} (bound {limit:.3g}: 1e-5 x {scale:.4g})")
            del server, gpu, cpu
        del float_server
    check(qstats["calls"] > 0 and qstats["bad_values"] == 0 and qstats["bad_scales"] == 0,
          f"quant_i8 vs its plain torch ops at the int8 forwards' activations: {dict(qstats)}")
    return launches, qstats


def check_i8_run_loop(name) -> dict:
    """25: the run loop under int8: cifar/nmg trains 2 epochs of 4
    iterations and tests in f32 (-train -test), then its checkpoint is
    re-tested with -test -int8 -int8Calib 2 and with -test -int8 (dynamic):
    the "==> int8:" lines, the test loss within 5% of the float one
    (tests/test_int8.py's contract), and per test or calibration forward
    the unfolded int8 forward's launches (a calibration forward and a
    dynamic one take two quant_i8 launches a part). Returns the launches
    of the two int8 runs."""
    from mgtpu_torch.pipelines.standard import net_opts

    cache = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    sess, out, _, wall = run_main(I8_RUN + ["-cache", cache, "-nEpochs", "2", "-epochSize", "4",
                                            "-train", "-test"])
    fp_loss = metric_lines(out, "int8 run loop float")[1][(2, "TESTING")][1]["avg.loss"]
    ckpt = str(Path(sess.opt.save) / "model_2.ckpt")
    per = {k: sum(c.values()) for k, c in record_kernel_shapes(
        False, net_opts(sess.opt), fold=False, int8=True).items()}
    n_test = -(-sess.loaders["test"].size() // sess.opt.batchSize)
    phase("i8 run loop", f"cifar/nmg f32 -train -test (2 x 4 iterations of 16) on {name} in "
          f"{wall:.1f} s: test avg.loss {fp_loss:.5f}; {ckpt.rsplit('/', 1)[-1]}")
    total = Counter()
    for calib in (2, 0):
        argv = (I8_RUN + ["-cache", cache, "-nEpochs", "1", "-retrain", ckpt, "-test", "-int8"]
                + (["-int8Calib", str(calib)] if calib else []))
        sess8, out8, got, wall8 = run_main(argv)
        loss = metric_lines(out8, "int8 run loop")[1][(1, "TESTING")][1]["avg.loss"]
        want = {k: (n_test + calib) * v for k, v in per.items()}
        # dynamic-scale forwards (calibration's, or all without it) take
        # two quant_i8 launches a part, static ones one
        want["quant_i8"] = per["quant_i8"] * (n_test + 2 * calib if calib else 2 * n_test)
        check(got == want, f"-int8 -int8Calib {calib}: launches {got}, expected {want} "
              f"({n_test} test and {calib} calibration forwards)")
        check("==> int8: conv kernels quantized" in out8
              and ("calibrated over 2 batches" in out8) == bool(calib),
              f"-int8 -int8Calib {calib}: the int8 lines missing from\n{out8[-2000:]}")
        check(abs(loss - fp_loss) <= I8_LOSS_RTOL * abs(fp_loss),
              f"-int8 -int8Calib {calib}: test loss {loss} vs float {fp_loss}")
        total.update(got)
        phase("i8 run loop", f"-retrain {Path(ckpt).name} {' '.join(argv[argv.index('-test'):])} "
              f"in {wall8:.1f} s: "
              f"test avg.loss {loss:.5f} ({loss / fp_loss - 1:+.2%} of the float loss; bound "
              f"{I8_LOSS_RTOL:.0%}); launches {got}")
    del sess, sess8
    shutil.rmtree(cache)
    return dict(total)


def time_i8(name, shapes, qshapes):
    """26: R-MG-34's int8 (static and dynamic scales) and bf16 serving
    forwards at batch 128 and 1, interleaved in one call (host included),
    with the card's busy time of one profiled
    call of each, and for the int8 static forward at 128 its kernels by
    name (top 10) and count; then conv_i8 at each shape of the int8
    forward at batch 128 (bf16 out, the epilogue operands its launch
    there takes) through its design and, where that is not simple,
    through the simple design, beside its plain version and, as a different function
    (bf16 operands), the conv3x3 kernel at the 3x3/s1 shapes and cuDNN's
    bf16 conv at every shape; then quant_i8 at each of the forward's
    quantizer groups (static scales; bf16 parts, f32 stem images): the
    group design's launch beside the per-part design's launches of the
    same members, its plain torch ops and, a different function on f32
    copies, torch.quantize_per_tensor (qint8) of each member; and the
    host us a call of the group wrapper and of the per-part wrappers.
    Returns ms per forward: {conv_i8 by design and in total, simple
    design at all, plain, conv3x3 bf16, cuDNN bf16, quant_i8 (group),
    quant_part, its plain ops, quantize_per_tensor, and the host ms of
    the group and the per-part wrappers}."""
    server8 = Server(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16, int8=True,
                     int8_calib=I8_CALIB)
    dynamic = Server(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16, int8=True)
    server16 = Server(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (TIME_BATCH, *IMAGE_SHAPE), dtype=np.float32)).cuda()
    fns = {f"int8 forward {TIME_BATCH}": lambda: server8.predict(images),
           f"bf16 forward {TIME_BATCH}": lambda: server16.predict(images),
           f"int8 dynamic forward {TIME_BATCH}": lambda: dynamic.predict(images),
           "int8 forward 1": lambda: server8.predict(images[:1]),
           "bf16 forward 1": lambda: server16.predict(images[:1]),
           "int8 dynamic forward 1": lambda: dynamic.predict(images[:1])}
    res = dict(zip(fns, interleaved_ms(list(fns.values()), windows=7, min_reps=3)))
    for what, (t, sp) in res.items():
        phase("i8 times", f"R-MG-{DEPTH} {what}: {t:.3f} ms (median of 7 interleaved windows, "
              f"spread {sp:.1%}) = {int(what.rsplit(' ', 1)[1]) / t * 1e3:.1f} img/s on {name}")
    for what, fn in fns.items():
        busy, by_name, wall, both, seen, counted = profile_kernels(fn)
        launched = sum(n for n, _ in by_name.values())
        phase("i8 times", f"R-MG-{DEPTH} {what}, profiled: " + (
            "no device time in the trace (not measured)" if not busy else
            f"card busy {busy:.3f} ms a call in {launched} kernels and copies, {wall:.3f} ms "
            f"wall under the profiler (against the median above the card is idle "
            f"{1 - busy / res[what][0]:.0%}); the trace holds {seen} of the {counted} launches "
            f"of the port's kernels the counters saw; key_averages' self device times, which "
            f"count a kernel a torch op launched twice, sum to {both:.3f}"))
        if busy and what == f"int8 forward {TIME_BATCH}":
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
            phase("i8 times", f"R-MG-{DEPTH} {what}, busy time by kernel (top 10 of "
                  f"{len(by_name)} names): " + "; ".join(
                      f"{k[:60]} x{n} {t:.3f} ms" for k, (n, t) in top))
    del server8, dynamic, server16, images
    ms = dict.fromkeys(("kernel", *cuda_conv_i8.DESIGNS, "simple_all", "plain", "conv3x3", "cudnn",
                        "quant_i8", "quant_part", "quant_plain", "quantize_per_tensor",
                        "host_quant_i8", "host_quant_part"), 0.0)
    for i, (key, count) in enumerate(sorted(shapes.items())):
        h, w, ci, co, k, stride, pad = key[:7]
        x8, w8, wk, v, sx = i8_operands(key, TIME_BATCH, seed=900 + i)
        oh, ow = cuda_conv_i8.out_size(h, k, stride, pad), cuda_conv_i8.out_size(w, k, stride, pad)
        y_in = (torch.zeros((TIME_BATCH, oh, ow, co), dtype=torch.bfloat16, device="cuda")
                if key[9] else None)
        bias = torch.zeros(co, device="cuda") if key[10] else None
        epi = dict(v=v, dtype=torch.bfloat16, sx=sx, y_in=y_in, bias=bias)
        xb = torch.randn((TIME_BATCH, h, w, ci), device="cuda").to(torch.bfloat16)
        wb = (torch.randn((k, k, key[7], co), device="cuda") / (k * ci ** 0.5)).to(
            torch.bfloat16)[:, :, key[8]:key[8] + ci]
        w_lib = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b = torch.zeros(co, device="cuda")
        route = cuda_conv_i8._route(x8, w8, stride, pad, wk)
        kfns = {route: lambda: cuda_conv_i8.conv_i8(x8, w8, stride, pad, wk=wk, **epi),
                "plain": lambda: cuda_conv_i8.conv_i8_plain(
                    x8, w8, stride, pad, v, torch.bfloat16, sx=sx,
                    y_in=None if y_in is None else y_in.clone(), bias=bias),
                "cudnn": lambda: F.conv2d(nchw(xb), w_lib, stride=stride, padding=pad)}
        if route != "simple":
            kfns["simple_all"] = lambda: cuda_conv_i8._simple_forward(x8, w8, stride, pad, **epi)
        if (k, stride, pad) == (3, 1, 1):
            kfns["conv3x3"] = lambda: conv3x3(xb, wb, b, with_stats=False)
        kres = dict(zip(kfns, device_ms(list(kfns.values()), windows=3)))
        for kk, (t, _) in kres.items():
            ms[kk] += count * t
        ms["kernel"] += count * kres[route][0]
        if route == "simple":
            ms["simple_all"] += count * kres[route][0]
        ops = i8_work(key, TIME_BATCH)[0]
        phase("i8 times", f"conv_i8 {TIME_BATCH}x{h}x{w}x{ci}->{co} k{k}/s{stride}/p{pad} "
              f"(x{count}/forward; {ops / 1e9:.1f} GOP): " + ", ".join(
                  f"{kk} {t:.4f} ms ({ops / t / 1e9:.1f} TOP/s, spread {sp:.1%})"
                  for kk, (t, sp) in kres.items()))
    for i, (keys, count) in enumerate(sorted(qshapes.items())):
        members = quant_members(keys, TIME_BATCH, 960 + 20 * i, static=True)
        xfs = [x.float() for x, _, _ in members]
        qfns = {"quant_i8": lambda: quant.quant_i8_group(members),
                "quant_part": lambda: [quant._part_forward(*m) for m in members],
                "quant_plain": lambda: quant.quant_i8_group_plain(members)}
        if ms["quantize_per_tensor"] is not None:
            try:  # a yardstick only: where this build refuses it, not measured
                torch.quantize_per_tensor(xfs[0], 0.05, 0, torch.qint8)
                qfns["quantize_per_tensor"] = lambda: [
                    torch.quantize_per_tensor(xf, 0.05, 0, torch.qint8) for xf in xfs]
            except RuntimeError as err:
                phase("i8 times", f"torch.quantize_per_tensor on the card: {err}"[:300])
                ms["quantize_per_tensor"] = None
        check(all(torch.equal(a[0], b[0]) and torch.equal(a[0], c[0]) for a, b, c in zip(
            qfns["quant_i8"](), qfns["quant_plain"](), qfns["quant_part"]())),
              f"quant_i8 at batch {TIME_BATCH} x {keys}: the group or per-part design differs "
              f"from the plain version")
        qres = dict(zip(qfns, device_ms(list(qfns.values()), windows=3)))
        for kk, (t, _) in qres.items():
            ms[kk] += count * t
        host = {d: host_us(qfns[d], n=100) for d in ("quant_i8", "quant_part")}
        for d, t in host.items():
            ms[f"host_{d}"] += count * t / 1e3
        nbytes = quant_bytes(keys, TIME_BATCH)
        phase("i8 times", f"quant_i8 group of {len(keys)} at batch {TIME_BATCH}: "
              f"{'; '.join(f'{h}x{w}x{c}->{oh}x{ow}' for h, w, c, oh, ow in keys)} "
              f"(x{count}/forward; {nbytes / 1e6:.1f} MB): " + ", ".join(
                  f"{kk} {t:.4f} ms ({nbytes / t / 1e6:.0f} GB/s, spread {sp:.1%})"
                  for kk, (t, sp) in qres.items())
              + f"; host us a call: the group wrapper {host['quant_i8']:.1f}, the per-part "
              f"wrappers {host['quant_part']:.1f} ({host['quant_part'] / len(keys):.1f} a part)")
    return ms


def i8_bounds_by_design(shapes, batch) -> dict:
    """{design: (launches, operations, bytes, bound ms, bound_by)} of the
    recorded conv_i8 calls ``shapes`` at ``batch``, split by the design
    _route gives each (i8_bounds of each part)."""
    parts = defaultdict(Counter)
    for key, count in shapes.items():
        design = next(d for d, n in i8_routes({key: 1}).items() if n)
        parts[design][key] = count
    return {d: (sum(c.values()), *i8_bounds(c, batch)) for d, c in parts.items()}


def time_i8_parts(i8_rec) -> dict:
    """26: conv_i8 at every stem and 1x1 part of cifar/prnmg's and unmg's
    int8 forwards (those _route sends to the stem and 1x1 designs;
    R-MG-34's three stems are time_i8's), at each net's serving batch,
    bf16 out with the epilogue operands its launch takes there: the design, the simple design, the plain version and, a
    different function (bf16 operands), cuDNN's bf16 conv, in turns on
    the card's clock (device_ms); at the 1x1 parts also the int32 sums
    through the design and simple beside torch._int_mm, which computes
    the same function (M > 16, K and N multiples of 8), checked equal
    once. Returns {net: {design: {launches, ms, simple_ms, plain_ms,
    cudnn_ms, bound_ms, bound_by, and for 1x1: int32_ms,
    int32_simple_ms, library_ms (torch._int_mm)}}}, per forward."""
    out = {}
    for net, (_, batches) in I8_SERVE.items():
        if net == "ilsvrc/rnmg":
            continue
        batch = batches[-1]
        res = {}
        for i, (key, count) in enumerate(sorted(i8_rec[net]["conv_i8"].items())):
            h, w, ci, co, k, stride, pad = key[:7]
            x8, w8, wk, v, sx = i8_operands(key, batch, seed=950 + i)
            route = cuda_conv_i8._route(x8, w8, stride, pad, wk)
            if route not in ("stem", "1x1"):
                continue
            oh, ow = cuda_conv_i8.out_size(h, k, stride, pad), cuda_conv_i8.out_size(w, k, stride, pad)
            y_in = (torch.zeros((batch, oh, ow, co), dtype=torch.bfloat16, device="cuda")
                    if key[9] else None)
            bias = torch.zeros(co, device="cuda") if key[10] else None
            epi = dict(v=v, dtype=torch.bfloat16, sx=sx, y_in=y_in, bias=bias)
            xb = torch.randn((batch, h, w, ci), device="cuda").to(torch.bfloat16)
            w_lib = (torch.randn((co, ci, k, k), device="cuda") / (k * ci ** 0.5)).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            fns = {"ms": lambda: cuda_conv_i8.conv_i8(x8, w8, stride, pad, wk=wk, **epi),
                   "simple_ms": lambda: cuda_conv_i8._simple_forward(x8, w8, stride, pad, **epi),
                   "plain_ms": lambda: cuda_conv_i8.conv_i8_plain(
                       x8, w8, stride, pad, v, torch.bfloat16, sx=sx,
                       y_in=None if y_in is None else y_in.clone(), bias=bias),
                   "cudnn_ms": lambda: F.conv2d(nchw(xb), w_lib, stride=stride, padding=pad)}
            if route == "1x1":
                x2, w2 = x8.view(-1, ci), w8.reshape(ci, co)
                check(torch.equal(torch._int_mm(x2, w2).view(batch, h, w, co),
                                  cuda_conv_i8.conv_i8(x8, w8, 1, 0, wk=wk)),
                      f"{net}: torch._int_mm and conv_i8 disagree at the 1x1 shape {key}")
                fns.update({"int32_ms": lambda: cuda_conv_i8.conv_i8(x8, w8, 1, 0, wk=wk),
                            "int32_simple_ms": lambda: cuda_conv_i8._simple_forward(x8, w8, 1, 0),
                            "library_ms": lambda: torch._int_mm(x2, w2)})
            times = dict(zip(fns, device_ms(list(fns.values()), windows=3)))
            ops, nbytes = i8_work(key, batch)
            bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
            part = res.setdefault(route, Counter())
            part["launches"] += count
            part["bound_ms"] += count * bound
            part["ops_ms"] += count * ops / PEAK_INT8_OPS * 1e3 * (ops / PEAK_INT8_OPS
                                                                   > nbytes / PEAK_HBM_BYTES)
            for kk, (t, _) in times.items():
                part[kk] += count * t
            phase("i8 times", f"{net} conv_i8 {route} {batch}x{h}x{w}x{ci}->{co} k{k}/s{stride}/"
                  f"p{pad} (x{count}/forward; bound {bound:.4f} ms by "
                  f"{'operations' if ops / PEAK_INT8_OPS > nbytes / PEAK_HBM_BYTES else 'bytes'}): "
                  + ", ".join(f"{kk.removesuffix('_ms').replace('library', 'torch._int_mm')} "
                              f"{t:.4f} ms (spread {sp:.1%})" for kk, (t, sp) in times.items()))
        for route, part in res.items():
            part = dict(part)
            part["bound_by"] = ("operations" if part["bound_ms"] and 2 * part.pop("ops_ms")
                                >= part["bound_ms"] else "bytes")
            part.pop("ops_ms", None)
            res[route] = part
            phase("i8 times", f"{net} conv_i8 {route} per batch-{batch} forward "
                  f"({part['launches']} launches): {part['ms']:.4f} ms, "
                  f"{part['bound_ms'] / part['ms']:.0%} of its {part['bound_ms']:.4f} ms bound "
                  f"(by {part['bound_by']}); simple {part['simple_ms']:.4f} ms, plain "
                  f"{part['plain_ms']:.4f} ms, cuDNN bf16 (a different function) "
                  f"{part['cudnn_ms']:.4f} ms" + (
                      f"; int32 out: {route} {part['int32_ms']:.4f} ms, simple "
                      f"{part['int32_simple_ms']:.4f} ms, torch._int_mm {part['library_ms']:.4f} "
                      f"ms ({'met' if part['int32_ms'] <= part['library_ms'] else 'missed'}: "
                      f"{route} at most torch._int_mm)" if route == "1x1" else ""))
        out[net] = res
    return out


# ------------------------------------ the saliency harness (phase 27)

SAL_RECIPE = "scripts/mnist-cluttered/mnist-saliency.sh"
SAL_TRAINED_RECIPE = "scripts/mnist-cluttered/pnmg.mnist.sh"
SAL_NET = "mnist-cluttered/pnmg.mnist"
SAL_PARAMS = 600_507
# -synthSize 8 at -saliencyBatch 4: two groups, each one forward of 4 x 842
# images of 64x64x1
SAL_SAMPLES, SAL_GROUP = 8, 4
SAL_TOL = 1e-5  # of the outputs' scale: the f32 forward, card vs CPU (phase 18's gate)


def saliency_argv(ckpt, dump, cache):
    return recipe_argv(SAL_RECIPE) + [
        "-trainedNet", ckpt, "-synthSize", str(SAL_SAMPLES), "-saliencyBatch", str(SAL_GROUP),
        "-saliencyDumpStack", str(dump), "-cache", cache]


def impacts(outputs, points):
    """(N, 7) impacts of the variants on the probes, as saliency_map
    takes them (numpy)"""
    diff = np.abs(outputs[1:] - outputs[:1])
    return np.stack([(diff * points[j]).reshape(len(diff), -1).max(1)
                     for j in range(len(points))], 1)


def check_saliency_runs(ckpt, cache, runs, res, per_forward, tol, sal_close) -> Counter:
    """27, the recipe through the entry point a user calls: python -m
    mgtpu_torch.main with mnist-saliency.sh's flags at the phase's sizes,
    at -saliencyDumpStack 1 and 0, whose saliency.run writes testOutput.h5
    through mgtpu_torch.utils.h5. Each file read back: exactly the groups
    of the samples ``runs[dump]`` kept (saliency_samples on the same
    checkpoint), points and input equal to theirs, saliency within
    ``sal_close``, outputs within ``tol``; the run's samples/s beside
    saliency_samples' (``res[dump]["wall"]``), the dump's MB and the
    writer's MB/s alone (the same arrays written again); then
    render_saliency on the dump-1 file. Returns the runs' launches."""
    launches = Counter()
    n_groups = -(-SAL_SAMPLES // SAL_GROUP)
    dumps = {}
    for dump in (1, 0):
        sess, out, got, wall = run_main(saliency_argv(ckpt, dump, cache))
        want = {k: n_groups * v for k, v in per_forward.items()}
        check(got == want, f"mnist-saliency through main, dump {dump}: launches {got}, "
              f"expected {want}")
        launches.update(got)
        path = Path(sess.opt.save) / "testOutput.h5"
        rate = re.search(rf"saliency: {SAL_SAMPLES} samples in [0-9.]+s \(([0-9.]+) samples/s, "
                         rf"group size {SAL_GROUP}\)", out)
        check(rate is not None and f"saliency maps -> {path}" in out,
              f"mnist-saliency through main, dump {dump}: no rate or dump line in {out[-600:]}")
        kept = runs[dump]
        n_read = 0
        with h5.File(path, "r") as f:
            check(f.keys() == [f"id{i:05d}" for i in sorted(kept)], f"{path.name} at dump "
                  f"{dump}: groups {f.keys()}, the kept samples {sorted(kept)}")
            for i, ref in kept.items():
                g = f[f"id{i:05d}"]
                check(sorted(g.keys()) == sorted(ref), f"id{i:05d}: datasets {g.keys()}")
                arrays = {k: np.asarray(g[k]) for k in ref}
                n_read += sum(a.nbytes for a in arrays.values())
                check(all(arrays[k].shape == ref[k].shape and arrays[k].dtype == ref[k].dtype
                          for k in ref), f"id{i:05d} at dump {dump}: shapes or dtypes differ")
                check(np.array_equal(arrays["points"], ref["points"])
                      and np.array_equal(arrays["input"], ref["input"])
                      and sal_close(arrays["saliency"], ref["saliency"]),
                      f"id{i:05d} at dump {dump}: points, input or saliency differ from "
                      f"saliency_samples' (saliency max abs err "
                      f"{np.abs(arrays['saliency'] - ref['saliency']).max():.3g})")
                if dump:
                    err = float(np.abs(arrays["output"] - ref["output"]).max())
                    check(err <= tol, f"id{i:05d}: outputs {err:.3g} from saliency_samples' "
                          f"(bound {tol:.3g})")
        size = path.stat().st_size
        # the writer alone: the same arrays written again, timed (page cache, warm)
        again = Path(cache) / f"written_again_{dump}.h5"
        t1 = time.perf_counter()
        with h5.File(again, "w") as f:
            for i, ref in kept.items():
                for k, v in ref.items():
                    f.create_dataset(f"id{i:05d}/{k}", data=v)
        write_s = time.perf_counter() - t1
        check(again.stat().st_size == size, f"the same arrays written again: "
              f"{again.stat().st_size} bytes, the run's dump {size}")
        dumps[dump] = path
        samples_rate = SAL_SAMPLES / res[dump]["wall"]
        phase("saliency", f"{SAL_RECIPE} through mgtpu_torch.main, -saliencyDumpStack {dump}, "
              f"in {wall:.1f} s: launches {got}; {path.name} read back through "
              f"mgtpu_torch.utils.h5: the {len(kept)} kept samples' groups, points and input "
              f"equal to saliency_samples', saliency within its gate; the run "
              f"{float(rate.group(1)):.3f} samples/s (its loop, writes included) beside "
              f"saliency_samples' {samples_rate:.3f} on this card; the dump {size / 1e6:.2f} MB "
              f"({n_read / 1e6:.2f} MB of arrays), written again alone in {write_s * 1e3:.1f} ms "
              f"= {size / 1e6 / write_s:.0f} MB/s")
        res[dump].update(run_rate=float(rate.group(1)), samples_rate=samples_rate,
                         dump_mb=size / 1e6, write_mb_s=size / 1e6 / write_s)
        del sess
    viz = Path(cache) / "viz"
    drawn = run_tool("render_saliency", "--h5", dumps[1], "--out", viz).splitlines()
    gids = [f"id{i:05d}" for i in sorted(runs[1])]
    check(drawn == gids + [f"renders -> {viz}"], f"render_saliency printed {drawn}")
    pngs = sorted(p.name for p in viz.glob("*.png"))
    check(len(pngs) == 10 * len(gids), f"render_saliency wrote {len(pngs)} PNGs for "
          f"{len(gids)} samples (10 each)")
    phase("saliency", f"mgtpu_torch.tools.render_saliency on the -saliencyDumpStack 1 dump: "
          f"{len(pngs)} PNGs for {len(gids)} samples")

    return launches


def check_saliency(name) -> tuple[dict, dict]:
    """27: the saliency harness on the card. A checkpoint of pnmg.mnist
    with scripts/mnist-cluttered/pnmg.mnist.sh's options (seeded weights,
    BatchNorms calibrated to their inputs as Server calibrates them),
    written by the port's writer; then scripts/mnist-cluttered/
    mnist-saliency.sh through the port's Session (-data synthetic, 8
    samples, -saliencyBatch 4: 3,368 images a forward, f32 as the recipe
    runs) at -saliencyDumpStack 1 (the host probe) and 0 (the stack
    built and probed on the card), each driven through
    saliency.saliency_samples: the pinned launches a forward through the designs
    predicted at batch 1, the run's samples/s, ms a group, peak memory,
    the forward's kernel time by kernel and the card's idle share; sample
    1's whole 842-stack held to the port's plain CPU forward (phase 18's
    gate: 1e-5 of the outputs' scale, or three times the CPU's own change
    under images moved by 1e-6 where that is larger), its valid and
    points bit for bit and its saliency within that bound carried through
    the impacts, for both dump modes; the card's probe on the card's
    stack against the host's on the same numbers (valid and points bit
    for bit, saliency at test_saliency.py's rtol 1e-5 / atol 1e-6); the
    outputs within the bound of the 0.4 threshold and the
    impacts within it of 0.1 counted; the two modes' samples against each
    other; then the recipe through mgtpu_torch.main at both dump modes,
    its testOutput.h5 read back through mgtpu_torch.utils.h5 and held to
    the kept samples, its samples/s beside saliency_samples', the dump's
    size and the writer's rate alone, and render_saliency on the dump-1
    file. Returns (the launches of the four runs, the times for the
    kernels line)."""
    from mgtpu_torch.data.mnist import occlusion_masks
    from mgtpu_torch.models import net_options
    from mgtpu_torch.nn import param_count
    from mgtpu_torch.pipelines import saliency
    from mgtpu_torch.pipelines.standard import Session, net_opts
    from mgtpu_torch.serve import calibrate_batchnorm
    from mgtpu_torch.utils.checkpoint import model_meta, save_checkpoint
    from mgtpu_torch.utils.opts import parse

    t0 = time.perf_counter()
    cache = tempfile.mkdtemp(prefix="chip_smoke_saliency_")
    with contextlib.redirect_stdout(io.StringIO()):
        topt = parse(recipe_argv(SAL_TRAINED_RECIPE) + ["-cache", cache])
    net_opt = net_options(net_opts(topt))
    gen = torch.Generator().manual_seed(0)
    model = create_model(net_opt, generator=gen)
    calibrate_batchnorm(model, gen, get_spec(SAL_NET).image_shape)
    check(param_count(model) == SAL_PARAMS, f"{SAL_NET}: {param_count(model)} params")
    ckpt = str(Path(cache) / "pnmg.mnist.ckpt")
    save_checkpoint(ckpt, model, None, 1, model_meta(topt))
    del model
    shapes = record_kernel_shapes(False, net_opt, fold=False)
    per_forward = {k: sum(c.values()) for k, c in shapes.items()}
    check(per_forward == SEG_PER_FORWARD[SAL_NET], f"{SAL_NET} eval forward: the CPU made "
          f"kernel calls {per_forward}, expected {SEG_PER_FORWARD[SAL_NET]}")
    routes = predicted_routes(shapes, torch.float32)
    n_stack = 1 + len(occlusion_masks())  # an image and its 841 occluded variants
    n_img = SAL_GROUP * n_stack
    phase("saliency", f"{SAL_NET} ({SAL_TRAINED_RECIPE}'s options, {SAL_PARAMS} params, seeded, "
          f"BNs calibrated) written to {Path(ckpt).name}; {SAL_RECIPE} at -synthSize "
          f"{SAL_SAMPLES} -saliencyBatch {SAL_GROUP}: {n_img} images a forward, f32; launches "
          f"a forward {per_forward}, designs predicted at batch 1: " + ", ".join(
              f"{k} {r} {n}" for (k, r), n in routes.items() if n))
    launches, runs, res = Counter(), {}, {}
    for dump in (1, 0):
        with contextlib.redirect_stdout(io.StringIO()):
            sess = Session(parse(saliency_argv(ckpt, dump, cache)))
        try:
            check(next(sess.model.parameters()).is_cuda and not sess.model.training,
                  "the harness's model is not on the card in eval mode")
            loader = sess.loaders["test"]
            step = saliency.GroupStep(sess.model, loader, SAL_GROUP, bool(dump), sess.device)
            group = np.stack([loader.get(i, i)[0][0] for i in range(1, SAL_GROUP + 1)])
            # one forward: its launches and designs at N = 3,368
            kernels.reset_launches()
            before = dict(kernels.ROUTES)
            out = step(group)
            torch.cuda.synchronize()
            got = {k: v for k, v in kernels.LAUNCHES.items()}
            check(got == per_forward, f"saliency dump {dump}: one group's launches {got}, "
                  f"expected {per_forward}")
            check(routes_since(before) == routes, f"saliency dump {dump}: designs at N = "
                  f"{n_img} {routes_since(before)}, predicted at batch 1 {routes}")
            if dump:  # sample 1's whole stack
                res["stack_dev"] = out[:n_stack].clone()
                res["stack"] = res["stack_dev"].cpu().numpy()
            del out
            list(saliency.saliency_samples(sess, step))  # warm up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t1 = time.perf_counter()
            samples = list(saliency.saliency_samples(sess, step))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            got = dict(kernels.LAUNCHES)
            n_groups = -(-SAL_SAMPLES // SAL_GROUP)
            want = {k: n_groups * v for k, v in per_forward.items()}
            check(got == want, f"saliency dump {dump}: the run's launches {got}, expected {want}")
            launches.update(got)
            peak = torch.cuda.max_memory_allocated()
            busy, by_name, _, _, seen, counted = profile_kernels(lambda: step(group))
            group_ms = wall / n_groups * 1e3
            runs[dump] = dict(samples)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
            phase("saliency", f"-saliencyDumpStack {dump} on {name}: {len(samples)} of "
                  f"{SAL_SAMPLES} samples kept; {SAL_SAMPLES / wall:.3f} samples/s, "
                  f"{group_ms:.1f} ms a group of {SAL_GROUP} (wall, host probe and copies "
                  f"included); peak memory {peak / 2**30:.2f} GiB; one group's device work "
                  f"profiled: card busy {busy:.1f} ms, idle {max(0.0, 1 - busy / group_ms):.0%} of the "
                  f"group's wall; {seen} of the {counted} port launches in the trace; by "
                  f"kernel: " + ", ".join(f"{k[:48]} {n}x {t:.2f} ms" for k, (n, t) in top))
            res[dump] = dict(wall=wall, group_ms=group_ms, peak=peak, busy=busy)
        finally:
            sess.pool.shutdown()
            del sess
    # sample 1's stack through the port's plain path on the CPU, f32
    cpu_model = get_spec("mnist-cluttered/mnist-saliency").create_model(
        NetOpts(netType="mnist-cluttered/mnist-saliency", trainedNet=ckpt))
    with contextlib.redirect_stdout(io.StringIO()):
        opt1 = parse(saliency_argv(ckpt, 1, cache) + ["-device", "cpu"])
    from mgtpu_torch.data import get_loaders

    x1 = get_loaders(opt1)["test"].get(1, 1)[0][0]
    moved = x1 * (1 + 1e-6 * np.random.default_rng(3).standard_normal(x1.shape,
                                                                      dtype=np.float32))
    t1 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(x1)).numpy()
        ref_moved = cpu_model(torch.from_numpy(moved)).numpy()
    cpu_s = time.perf_counter() - t1
    # phase 18's gate for the mnist nets' f32 forwards: 1e-5 of the
    # outputs' scale, or three times the change that moving the images by
    # 1e-6 makes to the CPU's own forward where that is larger
    scale = float(np.abs(ref).max())
    own = float(np.abs(ref_moved - ref).max())
    tol = max(SAL_TOL * scale, CIFAR_F32_OWN_FACTOR * own)
    err = float(np.abs(res["stack"] - ref).max())
    check(err <= tol, f"saliency: sample 1's {n_stack} outputs, card vs CPU max abs err {err:.3g} "
          f"(bound {tol:.3g}: 1e-5 x {scale:.4g}, or 3 x {own:.3g}, the CPU's own change under "
          f"images moved by 1e-6)")
    ref_points = saliency.interest_point(ref[0])
    near_out = int((np.abs(ref[0] - 0.4) <= tol).sum())
    near_imp = 0
    if ref_points is not None:
        near_imp = int((np.abs(impacts(ref, ref_points) - 0.1) <= tol).sum())
    phase("saliency", f"sample 1, {n_stack} outputs on the card vs the plain CPU forward (two "
          f"forwards in {cpu_s:.1f} s on the CPU): max abs err {err:.3g}, "
          f"{int((np.abs(res['stack'] - ref) > SAL_TOL * scale).sum())} of {ref.size} over "
          f"{SAL_TOL} x {scale:.4g} (bound {tol:.3g}: that, or 3 x {own:.3g}, the CPU's own "
          f"change under images moved by 1e-6); outputs within {tol:.3g} of the 0.4 threshold: "
          f"{near_out}; impacts within it of 0.1: {near_imp}")
    ref_sal = None if ref_points is None else saliency.saliency_map(ref, ref_points,
                                                                   loader.mask)
    # the saliency of other outputs: each impact moves by at most twice the
    # outputs' bound, and a pixel's saliency sums the impacts of the masks
    # that cover it (while no impact crosses 0.1: counted above)
    carried = 2 * tol * loader.mask.sum(0)

    def sal_close(got, want):
        return bool((np.abs(got - want) <= carried + 1e-5 * np.abs(want) + 1e-6).all())

    for dump in (1, 0):
        got = runs[dump].get(1)
        check((got is None) == (ref_points is None), f"saliency dump {dump}: sample 1 valid "
              f"{got is not None} on the card, {ref_points is not None} on the CPU")
        if got is not None:
            check(np.array_equal(got["points"], ref_points), f"saliency dump {dump}: sample 1's "
                  f"probe points differ from the CPU's")
            check(sal_close(got["saliency"], ref_sal), f"saliency dump {dump}: sample 1's "
                  f"saliency vs the CPU's, max abs err {np.abs(got['saliency'] - ref_sal).max():.3g} "
                  f"(bound 2 x {tol:.3g} x the masks over a pixel, up to {carried.max():.3g})")
    # the probe on the card and on the host, on the same outputs (sample 1's
    # card stack): test_saliency.py's tolerance
    valid, points = saliency.interest_points(res["stack_dev"][:1])
    sal_dev = saliency.saliency_maps(res["stack_dev"][None], points, torch.from_numpy(
        loader.mask).cuda())[0].cpu().numpy()
    host_points = saliency.interest_point(res["stack"][0])
    check(bool(valid[0]) == (host_points is not None), "sample 1: the card's probe and the "
          "host's disagree on valid")
    probe_err = 0.0
    if host_points is not None:
        host_sal = saliency.saliency_map(res["stack"], host_points, loader.mask)
        probe_err = float(np.abs(sal_dev - host_sal).max())
        check(np.array_equal(points[0].cpu().numpy(), host_points)
              and np.allclose(sal_dev, host_sal, rtol=1e-5, atol=1e-6),
              f"sample 1: the card's probe vs the host's on the same outputs: points equal "
              f"{np.array_equal(points[0].cpu().numpy(), host_points)}, saliency max abs err "
              f"{probe_err:.3g} (rtol 1e-5, atol 1e-6)")
    check(sorted(runs[0]) == sorted(runs[1]), f"saliency: samples kept {sorted(runs[1])} with "
          f"the host probe, {sorted(runs[0])} with the card's")
    sal_err = 0.0
    for i in runs[1]:
        a, b = runs[1][i], runs[0][i]
        check(np.array_equal(a["points"], b["points"]) and np.array_equal(a["input"], b["input"]),
              f"saliency sample {i}: points or input differ between the two dump modes")
        check(sal_close(b["saliency"], a["saliency"]), f"saliency sample {i}: the card-built "
              f"stack's saliency vs the host-built one's, max abs err "
              f"{np.abs(b['saliency'] - a['saliency']).max():.3g}")
        sal_err = max(sal_err, float(np.abs(b["saliency"] - a["saliency"]).max()))
    cpu_err = 0.0 if ref_sal is None else float(np.abs(runs[1][1]["saliency"] - ref_sal).max())
    phase("saliency", f"sample 1: valid and points equal the CPU's in both dump modes, its "
          f"saliency within {cpu_err:.3g} of the CPU's (bound 2 x {tol:.3g} x the masks over a "
          f"pixel, up to {carried.max():.3g}); the card's probe on the card's outputs equals the "
          f"host's (points; saliency within {probe_err:.3g}, rtol 1e-5 / atol 1e-6); the "
          f"{len(runs[1])} kept samples: points and input equal in both dump modes, saliency "
          f"within {sal_err:.3g}; a group takes {res[1]['group_ms'] / res[0]['group_ms']:.2f}x "
          f"as long with the host's probe as with the card's")
    launches.update(check_saliency_runs(ckpt, cache, runs, res, per_forward, tol, sal_close))
    # conv3x3 and maxpool2 at the saliency forward's shapes, N = 3,368, f32:
    # the path's calls (relu_out and stats off) held to the plain version, then timed
    worst, pool_ok = 0.0, 0
    for k, ((h, w, ci, co), _) in enumerate(sorted(shapes["conv3x3"].items())):
        x, wt, b = conv_inputs(n_img, h, w, ci, co, torch.float32, seed=700 + k)
        y = routed("conv3x3", x, wt, lambda: conv3x3(x, wt, b, with_stats=False))[0]
        y_ref = conv3x3_plain(x, wt, b, with_stats=False)[0]
        share = rel_share(y, y_ref, 1e-5)
        check(share <= 1.0, f"conv3x3 {n_img}x{h}x{w}x{ci}->{co} f32: {share:.2f} of its bound")
        worst = max(worst, share)
        del x, y, y_ref
    for k, (h, w, c) in enumerate(sorted(shapes["maxpool2"])):
        x = pool_input((n_img, h, w, c), torch.float32, seed=800 + k)
        same, _ = pool_equal(maxpool2(x), maxpool2_plain(x))
        check(same, f"maxpool2 {n_img}x{h}x{w}x{c} f32: differs from the plain version")
        pool_ok += 1
        del x
    torch.cuda.empty_cache()
    phase("saliency", f"conv3x3 at the forward's {len(shapes['conv3x3'])} shapes at N = {n_img}, "
          f"f32, as the path calls it: largest error {worst:.2f} of its bound; maxpool2 at its "
          f"{pool_ok} shapes: equal to the plain version")
    label = f"mnist-saliency ({SAL_NET}, {n_img} a forward)"
    t_ms, t_plain, t_lib, t_simple, t_designs = time_kernels(
        label, shapes, {k: Counter() for k in KERNELS}, n_img, 1, 1, seed=900,
        alternatives=False, windows=3, dtype=torch.float32)
    check_conv_tf32([(shape, n_img) for shape in shapes["conv3x3"]], f"saliency at {n_img}: ")
    time_tf32(shapes["conv3x3"], n_img)
    # (the bounds at the f32 peak outside the tensor cores: main prints them)
    bounds = path_bounds(shapes, n_img, torch.float32)
    shutil.rmtree(cache)
    phase("saliency", f"phase 27 took {time.perf_counter() - t0:.1f} s")
    return dict(launches), (label, (f"{n_img}-image forward", ""), t_ms, t_plain, t_lib,
                            t_simple, t_designs, bounds)


# ----------------------------------------------- the remat step (phase 28)

# the dropout net of the remat check, at its recipe
REMAT_DROPOUT = "cifar/prnmg"


def step_delta(trainer, x, y, lr, wd):
    """One Trainer.step: (its loss, the parameter update as one f32
    vector, the running stats after it as one vector, peak memory over
    what was allocated before it, wall ms)."""
    p0 = np.concatenate([a.ravel() for a in flat(export_jax_tree(trainer.model)[0])])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss = float(trainer.step(x, y, lr, wd)["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    p, s = export_jax_tree(trainer.model)
    d = np.concatenate([a.ravel() for a in flat(p)]) - p0
    return loss, d, np.concatenate([a.ravel() for a in flat(s)]), peak, wall


def remat_pair(opt, x, y, lr, wd, iters, dtype=torch.bfloat16):
    """The plain step twice and the remat step once, each from the same
    seeded weights, zero momentum and init stats: ({"plain", "again",
    "remat"}: step_delta, {"remat": its launches and designs})."""
    out, seen = {}, {}
    for key, remat in (("plain", False), ("again", False), ("remat", True)):
        tr = Trainer(opt, seed=0, device="cuda", compute_dtype=dtype, iter_size=iters,
                     remat=remat)
        kernels.reset_launches()
        before = dict(kernels.ROUTES)
        out[key] = step_delta(tr, x, y, lr, wd)
        seen[key] = (dict(kernels.LAUNCHES), routes_since(before))
        del tr
        torch.cuda.empty_cache()
    return out, seen


def remat_errors(out):
    """(the plain step's own change between two runs, remat's change from
    the plain step: each the L2 of the update's difference over the
    update's L2; the same two for the running stats: max abs difference
    over the stats' scale)"""
    (_, d1, s1, _, _), (_, d2, s2, _, _), (_, dr, sr, _, _) = (
        out["plain"], out["again"], out["remat"])
    n1 = np.linalg.norm(d1)
    sc = max(np.abs(s1).max(), 1e-12)
    return (float(np.linalg.norm(d2 - d1) / n1), float(np.linalg.norm(dr - d1) / n1),
            float(np.abs(s2 - s1).max() / sc), float(np.abs(sr - s1).max() / sc))


def check_remat(name) -> dict:
    """28: -remat on the card. R-MG-34 bf16 at batch 128 (the main path):
    one Trainer.step with remat beside two without, from the same seeded
    weights and batch: the update within three times the plain step's
    own change between its two runs, the running stats likewise (updated
    once, as the plain step's), the pinned launches a micro-batch
    (REMAT_PER_STEP: the forward's kernels twice) through the predicted
    designs, a lower peak memory, and both steps' times interleaved;
    cifar/prnmg --isDropout at its recipe's 64 x 2 the same way (the
    masks replayed: a fresh draw moves the update far past the bound);
    one f32 remat step of cifar/prnmg (8 x 2) on the card vs the CPU's
    remat step, within the f32 step gates. Returns the launches of the
    remat steps."""
    t0 = time.perf_counter()
    launches = Counter()
    x, y = synthetic_batch(TIME_BATCH, seed=5)
    out, seen = remat_pair(RMG34, x, y, TRAIN_RULE["lr"], TRAIN_RULE["wd"], 1)
    rec = record_kernel_shapes(True, remat=True)
    want = {k: sum(c.values()) for k, c in rec.items()}
    check(want == REMAT_PER_STEP, f"the CPU's remat micro-batch made kernel calls {want}, "
          f"expected {REMAT_PER_STEP}")
    got, routes = seen["remat"]
    check(got == REMAT_PER_STEP and routes == predicted_routes(rec), f"R-MG-{DEPTH} remat step: "
          f"launches {got}, designs {routes}; expected {REMAT_PER_STEP}, "
          f"{predicted_routes(rec)}")
    check(seen["plain"][0] == seen["again"][0] == PER_STEP,
          f"R-MG-{DEPTH} plain steps: launches {seen['plain'][0]}, {seen['again'][0]}")
    launches.update(got)
    own, upd, own_st, st = remat_errors(out)
    lp, lr_ = out["plain"][0], out["remat"][0]
    check(np.isfinite(lr_) and abs(lr_ - lp) <= 3 * abs(out["again"][0] - lp),
          f"R-MG-{DEPTH} remat loss {lr_} vs plain {lp} (again {out['again'][0]})")
    check(upd <= 3 * own and st <= 3 * own_st, f"R-MG-{DEPTH} remat vs plain: update err {upd:.3g} "
          f"(bound 3 x the plain step's own {own:.3g}), stats err {st:.3g} (bound 3 x "
          f"{own_st:.3g})")
    peak_plain, peak_remat = out["plain"][3], out["remat"][3]
    check(peak_remat < peak_plain, f"R-MG-{DEPTH} remat peak {peak_remat / 2**30:.2f} GiB, plain "
          f"{peak_plain / 2**30:.2f} GiB")
    phase("remat", f"R-MG-{DEPTH} bf16, batch {TIME_BATCH}, one step on {name}: loss {lp:.6f} "
          f"both; update: remat vs plain {upd:.3g} of its L2 norm, the plain step against itself "
          f"{own:.3g} (bound 3x); running stats {st:.3g} vs {own_st:.3g} of their scale; "
          f"launches {got} (the forward's twice), designs as predicted; the step's peak memory "
          f"over the resident model {peak_remat / 2**30:.3f} GiB with remat, "
          f"{peak_plain / 2**30:.3f} GiB without ({peak_remat / peak_plain:.0%})")
    plain_tr = Trainer(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    remat_tr = Trainer(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16, remat=True)
    xt, yt = torch.from_numpy(x).cuda().to(torch.bfloat16), torch.from_numpy(y).cuda()
    (t_p, s_p), (t_r, s_r) = interleaved_ms([
        lambda: plain_tr.step(xt, yt, TRAIN_RULE["lr"], TRAIN_RULE["wd"]),
        lambda: remat_tr.step(xt, yt, TRAIN_RULE["lr"], TRAIN_RULE["wd"])], windows=5)
    phase("remat", f"R-MG-{DEPTH} bf16 step, batch {TIME_BATCH}, interleaved: plain {t_p:.2f} ms "
          f"(spread {s_p:.1%}) = {TIME_BATCH / t_p * 1e3:.1f} img/s, remat {t_r:.2f} ms (spread "
          f"{s_r:.1%}) = {TIME_BATCH / t_r * 1e3:.1f} img/s ({t_r / t_p:.2f}x)")
    del plain_tr, remat_tr
    torch.cuda.empty_cache()

    _, micro, iters = CIFAR_RECIPES[REMAT_DROPOUT]
    dopt = cifar_opts(REMAT_DROPOUT, dropout=True)
    x, y = synthetic_batch(micro * iters, seed=6, n_classes=100, shape=CIFAR_IMAGE)
    out, seen = remat_pair(dopt, x, y, CIFAR_LR, 5e-4, iters)
    rec = record_kernel_shapes(True, dopt, remat=True)
    want = {k: iters * sum(c.values()) for k, c in rec.items()}
    fwd = ("conv3x3", "conv3x3_bn_relu_in", "maxpool2")
    check(want == {k: iters * n * (2 if k in fwd else 1)
                   for k, n in PRNMG_DROPOUT_PER_MICRO.items()},
          f"{REMAT_DROPOUT} --isDropout remat: the CPU's calls {want}")
    check(seen["remat"][0] == want, f"{REMAT_DROPOUT} --isDropout remat step: launches "
          f"{seen['remat'][0]}, expected {want}")
    launches.update(seen["remat"][0])
    own, upd, own_st, st = remat_errors(out)
    check(upd <= 3 * own and st <= 3 * own_st, f"{REMAT_DROPOUT} --isDropout remat vs plain: "
          f"update err {upd:.3g} (bound 3 x {own:.3g}), stats err {st:.3g} (bound 3 x "
          f"{own_st:.3g})")
    phase("remat", f"{REMAT_DROPOUT} --isDropout bf16, {micro} x {iters}: update remat vs plain "
          f"{upd:.3g}, plain vs itself {own:.3g}; stats {st:.3g} vs {own_st:.3g}; launches "
          f"{seen['remat'][0]}; peak {out['remat'][3] / 2**20:.0f} MiB with remat, "
          f"{out['plain'][3] / 2**20:.0f} MiB without")

    fopt = cifar_opts(REMAT_DROPOUT)
    x2, y2 = synthetic_batch(CIFAR_F32_BATCH, seed=2, n_classes=100, shape=CIFAR_IMAGE)
    res = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(fopt, seed=0, device=dev, compute_dtype=torch.float32, iter_size=2,
                     remat=True)
        before, _ = export_jax_tree(tr.model)
        m = tr.step(x2, y2, 0.1, 5e-4)
        res[dev] = (float(m["loss"]), before, *export_jax_tree(tr.model))
    loss_err, upd, st = step_error(res)
    check(loss_err <= 1e-4 and upd <= F32_STEP_PARAM_BOUND and st <= F32_STEP_STATS_BOUND,
          f"{REMAT_DROPOUT} f32 remat step, card vs CPU: loss err {loss_err:.3g}, update err "
          f"{upd:.3g} (bound {F32_STEP_PARAM_BOUND}), stats err {st:.3g} (bound "
          f"{F32_STEP_STATS_BOUND})")
    phase("remat", f"{REMAT_DROPOUT} f32 remat step on the card vs the CPU's remat step, "
          f"{CIFAR_F32_BATCH // 2} x 2 at lr 0.1: loss err {loss_err:.3g}; update err {upd:.3g} "
          f"(bound {F32_STEP_PARAM_BOUND}); stats err {st:.3g} (bound {F32_STEP_STATS_BOUND}); "
          f"phase 28 took {time.perf_counter() - t0:.1f} s")
    return dict(launches)


DP_NET = "cifar/prnmg"  # its recipe's 64 x 2 as 32 x 2 a rank; every kernel on its path
DP_STEPS = 4


def dp_step(tr, x, y, lr, wd):
    """One step of ``tr``: (loss, params before, params after, stats after)."""
    before, _ = export_jax_tree(tr.model)
    m = tr.step(x, y, lr, wd)
    return (float(m["loss"]), before, *export_jax_tree(tr.model))


def dp_rank(rank, init, out_dir) -> None:
    """One of phase 29's two ranks, a spawned process on cuda:0, joined
    over gloo (NCCL takes one rank a card): one f32 step of DP_NET on its
    half of the global 64 x 2 batch (rank 0 writes the step's state),
    then DP_STEPS bf16 steps with the kernels' counts set to 0 just
    before and read just after, the same bits on both ranks held after
    each, each step timed (host clock to the loss read), and one
    gradient all-reduce of the model's parameters' size timed. Writes
    out_dir/rank<r>.json."""
    import torch.distributed as dist

    from mgtpu_torch.parallel import all_reduce_mean, make_mesh, same_bits

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(2, rank=rank, device="cuda:0", init_method=init, backend="gloo")
    try:
        _, micro, iters = CIFAR_RECIPES[DP_NET]
        x, y = synthetic_batch(micro * iters, seed=7, n_classes=100, shape=CIFAR_IMAGE)
        tr = Trainer(cifar_opts(DP_NET), seed=0, device="cuda:0", compute_dtype=torch.float32,
                     iter_size=iters, mesh=mesh)
        res = dp_step(tr, x, y, 0.1, 5e-4)
        if rank == 0:
            np.savez(Path(out_dir) / "f32.npz", loss=res[0], **{
                f"{k}/{i}": a for k, tree in zip("bps", res[1:]) for i, a in enumerate(flat(tree))})
        del tr
        tr = Trainer(cifar_opts(DP_NET), seed=0, device="cuda:0", compute_dtype=torch.bfloat16,
                     iter_size=iters, mesh=mesh)
        wd = tr.net.train_rule(1, tr.opt)["wd"]
        losses, bits, step_ms, launches = [], [], [], Counter()
        for _ in range(DP_STEPS):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(tr.step(x, y, CIFAR_LR, wd)["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.update(kernels.LAUNCHES)
            bits.append(same_bits(mesh, [*tr.model.parameters(), *tr.model.buffers()]))
        grads = [torch.ones_like(p) for p in tr.model.parameters()]
        ar_ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_mean(mesh, grads)
            torch.cuda.synchronize()
            ar_ms.append((time.perf_counter() - t0) * 1e3)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
            "losses": losses, "bits": bits, "launches": dict(launches), "step_ms": step_ms,
            "allreduce_ms": ar_ms[1:], "allreduce_bytes": sum(g.nbytes for g in grads)}))
    finally:
        dist.destroy_process_group()


def check_dp(name, power) -> dict:
    """29: data parallelism. (a) DP_NET at its recipe's 64 x 2, two ranks
    on the one card over gloo (32 x 2 each): the f32 step against the
    one-rank step on the card (loss within 1e-5 relative, the update and
    stats within the f32 step gates); DP_STEPS bf16 steps: the loss
    falls, both ranks hold the same bits after each, each rank's launches
    the one-rank pins for its micro-batches (all four kernels on both);
    each rank's step time and one gradient all-reduce's, gloo on one
    card (not NCCL, not scaling). (b) An NCCL group of one: the f32 step
    bit for bit the group-less step. (c) The launcher: the recipe's -nGPU
    4 on one card prints the clamp and runs one rank. Returns the
    ranks' bf16 launches, summed."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from mgtpu_torch.main import free_port
    from mgtpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    _, micro, iters = CIFAR_RECIPES[DP_NET]
    x, y = synthetic_batch(micro * iters, seed=7, n_classes=100, shape=CIFAR_IMAGE)
    one = dp_step(Trainer(cifar_opts(DP_NET), seed=0, device="cuda", compute_dtype=torch.float32,
                          iter_size=iters), x, y, 0.1, 5e-4)
    tr = Trainer(cifar_opts(DP_NET), seed=0, device="cuda", compute_dtype=torch.bfloat16,
                 iter_size=iters)
    wd = tr.net.train_rule(1, tr.opt)["wd"]
    one_ms = []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(tr.step(x, y, CIFAR_LR, wd)["loss"])
        one_ms.append((time.perf_counter() - t0) * 1e3)
    del tr

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(dp_rank, args=(f"tcp://127.0.0.1:{free_port()}", tmp), nprocs=2,
                           start_method="spawn")
        spawn_s = time.perf_counter() - t0
        got = np.load(Path(tmp) / "f32.npz")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in (0, 1)]
    # step_error's trees: the ranks' leaves and the one-rank step's, in flat()'s order
    res = {"cuda": (float(got["loss"]), *({f"{i:06d}": got[f"{k}/{i}"]
                                            for i in range(len(flat(tree)))}
                                           for k, tree in zip("bps", one[1:]))),
           "cpu": one}
    loss_err, upd, st = step_error(res)
    check(loss_err <= 1e-5 and upd <= F32_STEP_PARAM_BOUND and st <= F32_STEP_STATS_BOUND,
          f"{DP_NET} f32 step, two ranks vs one on the card: loss err {loss_err:.3g} (bound "
          f"1e-5), update err {upd:.3g} (bound {F32_STEP_PARAM_BOUND}), stats err {st:.3g} "
          f"(bound {F32_STEP_STATS_BOUND})")
    phase("dp", f"{DP_NET} f32, {micro} x {iters} as {micro // 2} x {iters} on each of two "
          f"ranks (spawned processes, gloo, one card) vs one rank on the global batch: loss "
          f"{res['cuda'][0]:.6f} vs {one[0]:.6f} (err {loss_err:.3g}, bound 1e-5); update err "
          f"{upd:.3g} of its L2 norm (bound {F32_STEP_PARAM_BOUND}); running stats err "
          f"{st:.3g} of their scale (bound {F32_STEP_STATS_BOUND})")
    want = {k: DP_STEPS * iters * n for k, n in CIFAR_PER_MICRO[DP_NET].items()}
    for r, rk in enumerate(ranks):
        check(rk["losses"] == ranks[0]["losses"] and all(rk["bits"]),
              f"rank {r}: losses {rk['losses']} (rank 0 {ranks[0]['losses']}), the same bits "
              f"as rank 0 after each step: {rk['bits']}")
        check(rk["launches"] == want, f"rank {r}: launches {rk['launches']} in {DP_STEPS} "
              f"steps, expected {want}")
    losses = ranks[0]["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"two ranks: losses {losses}")
    med = [statistics.median(rk["step_ms"][1:]) for rk in ranks]
    ar = statistics.median(ranks[0]["allreduce_ms"])
    nbytes = ranks[0]["allreduce_bytes"]
    phase("dp", f"{DP_NET} bf16, {DP_STEPS} steps on two ranks: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; parameters and stats the same bits on "
          f"both ranks after every step; launches per rank {want} (the one-rank pins for "
          f"{DP_STEPS} x {iters} micro-batches of {micro // 2})")
    phase("dp", f"times on {power} (gloo, two ranks sharing one card: not NCCL, not "
          f"scaling): a rank's {micro // 2} x {iters} step {med[0]:.1f} / {med[1]:.1f} ms "
          f"(median of steps 2-{DP_STEPS}, host clock to the loss read), one rank's "
          f"{micro} x {iters} step {statistics.median(one_ms[1:]):.1f} ms; the gradient "
          f"all-reduce of {nbytes / 1e6:.1f} MB (f32, one bucket) {ar:.2f} ms "
          f"({nbytes / ar / 1e6:.2f} GB/s); the two ranks' processes took {spawn_s:.1f} s")

    # (b) NCCL as a group of one: the collectives run, and change no bit
    mesh = make_mesh(1, device="cuda:0", init_method=f"tcp://127.0.0.1:{free_port()}",
                     backend="nccl")
    try:
        grouped = dp_step(Trainer(cifar_opts(DP_NET), seed=0, device="cuda",
                                  compute_dtype=torch.float32, iter_size=iters, mesh=mesh),
                          x, y, 0.1, 5e-4)
    finally:
        dist.destroy_process_group()
    same = grouped[0] == one[0] and all(np.array_equal(a, b) for t, u in zip(grouped[1:], one[1:])
                                        for a, b in zip(flat(t), flat(u)))
    check(same, f"{DP_NET} f32 step in an NCCL group of one differs from the group-less step")
    phase("dp", f"{DP_NET} f32 step in an NCCL group of one (the gradients, metrics and the "
          f"replica check through NCCL): loss, parameters and stats bit for bit the group-less "
          f"step's")

    # (c) the launcher on one card
    with tempfile.TemporaryDirectory() as tmp:
        argv = recipe_argv("scripts/cifar/prnmg.sh") + [
            "-nEpochs", "1", "-epochSize", "1", "-synthSize", "256", "-nDonkeys", "1",
            "-cache", tmp]
        argv.remove("-test")
        sess, out, cli, wall = run_main(argv)
    check("==> nGPU clamped to 1 (1 CUDA devices)" in out and sess.mesh.size == 1
          and sess.mesh.group is None, f"-nGPU 4 on one card: {out[-800:]}")
    check(cli == {k: iters * n for k, n in CIFAR_PER_MICRO[DP_NET].items()},
          f"the launcher's one-rank step: launches {cli}")
    metric_lines(out, "the launcher")
    phase("dp", f"scripts/cifar/prnmg.sh (-nGPU 4) through mgtpu_torch.main on one card, one "
          f"iteration: \"==> nGPU clamped to 1 (1 CUDA devices)\", one rank, the step's "
          f"pinned launches, in {wall:.1f} s; phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return dict(sum((Counter(rk["launches"]) for rk in ranks), Counter()))


# 30: the tools on the card (mgtpu_torch/tools)
TOOLS_RMG34_PARAMS, TOOLS_RMG34_MACS = 32_899_176, 5_760_277_760  # the published counts
# the exported programs' pinned launches per forward: Server.predict's
TOOLS_I8_PER_FORWARD = launch_counts(0, 0, 46, 0, 155, 33)
# the serving side of the exported programs, in one fresh process. First
# it imports what registers the mgtpu:: ops and nothing of the model code:
# each program runs one forward to build and warm up, one counted
# forward, and TOOLS_WINDOWS windows of TOOLS_REPS timed ones alone, and
# the child prints one JSON line a program, then the model code it
# imported (none). Then it imports the model code, builds each program's
# Server from the flags it was exported with, and times the program and
# Server.predict in turns (TOOLS_WINDOWS windows of TOOLS_REPS each, the
# order alternating), one JSON line a program; last, the launches of
# every forward it ran, as its counter read them.
TOOLS_WINDOWS, TOOLS_REPS = 15, 5
TOOLS_CHILD = r"""
import json, statistics, sys
from collections import Counter
import numpy as np, torch
from mgtpu_torch import kernels
from mgtpu_torch.tools import serve_exported


def windows(fns, n, reps):
    # each of fns' ms a call in n windows of reps calls, host included, in
    # turns whose order alternates from window to window
    for fn in fns:
        fn()
    per = [[] for _ in fns]
    for i in range(n):
        for j in (range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fns[j]()
            b.record()
            b.synchronize()
            per[j].append(a.elapsed_time(b) / reps)
    return per


def summary(ms):
    # the median, and the spread (max - min) over it
    return statistics.median(ms), (max(ms) - min(ms)) / statistics.median(ms)


xs, n, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
jobs = [json.loads(a) for a in sys.argv[4:]]
images = torch.from_numpy(np.load(xs)).cuda()
kernels.reset_launches()
fwds = []
for job in jobs:
    fwd, (shape, dtype) = serve_exported.load(job["art"], "cuda")
    run = lambda fwd=fwd, dtype=dtype: fwd(images.to(dtype))
    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        launches, routes = Counter(kernels.LAUNCHES), Counter(kernels.ROUTES)
        y = run()
        torch.cuda.synchronize()
        per = {k: v - launches[k] for k, v in kernels.LAUNCHES.items()}
        routes = {f"{k}/{r}": v - routes[(k, r)] for (k, r), v in kernels.ROUTES.items()
                  if v - routes[(k, r)]}
        np.save(job["out"], y.float().cpu().numpy())
        ms, spread = summary(windows([run], n, reps)[0])
    fwds.append(run)
    print(json.dumps({"shape": list(shape), "dtype": str(dtype), "launches": per,
                      "routes": routes, "ms": ms, "spread": spread}))
    del y
print(json.dumps(sorted(m for m in sys.modules if m in ("jax", "mgtpu", "mgtpu_torch.nn",
                 "mgtpu_torch.serve", "mgtpu_torch.trainer", "mgtpu_torch.ops.mg")
                 or m.startswith(("jax.", "mgtpu.", "mgtpu_torch.models")))))
from mgtpu_torch.tools import export_model
for job, run in zip(jobs, fwds):
    server = export_model.build_server(export_model.parser().parse_args(job["flags"]))
    with torch.no_grad():
        own, ref = windows([run, lambda: server.predict(images)], n, reps)
    # each window's program time over the Server.predict window beside it
    ratios = [a / b for a, b in zip(own, ref)]
    print(json.dumps({"ms": summary(own), "predict_ms": summary(ref),
                      "ratio": statistics.quantiles(ratios, n=4)}))
    del server
print(json.dumps(dict(kernels.LAUNCHES)))
"""


def serve_exported_child(xs, jobs) -> tuple[list, list, list, dict, float]:
    """TOOLS_CHILD on the images ``xs`` (.npy) and ``jobs`` [{"art": the
    program, "out": its outputs' .npy, "flags": the export_model flags it
    was exported with}] in a fresh process from the repository's root:
    (its JSON line a program from the serving alone, the model code it
    imported then, its JSON line a program from the turns with
    Server.predict, the launches of all its forwards, its wall
    seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", TOOLS_CHILD, str(xs), str(TOOLS_WINDOWS),
                        str(TOOLS_REPS), *(json.dumps(job) for job in jobs)],
                       capture_output=True, text=True, timeout=600,
                       cwd=Path(__file__).resolve().parent)
    check(r.returncode == 0, f"serve_exported in a fresh process failed ({r.returncode}): "
          f"{r.stderr[-3000:]}")
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()[-2 * len(jobs) - 2:]]
    k = len(jobs)
    return lines[:k], lines[k], lines[k + 1:2 * k + 1], lines[-1], time.perf_counter() - t0


def host_us(fn, n=300) -> float:
    """Host microseconds a call of fn: n calls enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def ops_host_cost(power) -> None:
    """The host cost of a kernel as an mgtpu:: op against its wrapper's
    direct call (the eager forward's) at one R-MG-34 shape (batch 8,
    14x14x256, bf16 / int8), in turns: what the wrappers' direct call
    outside torch.export rests on. Not counted as a main-path run."""
    from mgtpu_torch.ops import library  # noqa: F401 (registers the ops)

    ops = torch.ops.mgtpu
    g = torch.Generator(device="cuda").manual_seed(0)
    x8 = torch.randint(-127, 128, (8, 14, 14, 256), dtype=torch.int8, device="cuda", generator=g)
    w8 = torch.randint(-127, 128, (3, 3, 256, 256), dtype=torch.int8, device="cuda", generator=g)
    wk = cuda_conv_i8.pack_weight(w8)
    v, sx = torch.rand(256, device="cuda", generator=g), torch.tensor(0.01, device="cuda")
    xb = torch.randn((8, 14, 14, 256), device="cuda", dtype=torch.bfloat16, generator=g)
    wb = torch.randn((3, 3, 256, 256), device="cuda", dtype=torch.bfloat16, generator=g) * 0.02
    bb = torch.zeros(256, device="cuda", dtype=torch.float32)
    with torch.no_grad():
        for label, direct, op in (
                ("conv3x3", lambda: cuda_conv.conv3x3_forward(xb, wb, bb, relu_out=True,
                                                              with_stats=False),
                 lambda: ops.conv3x3(xb, wb, bb, True, False)),
                ("conv_i8", lambda: cuda_conv_i8.conv_i8(x8, w8, 1, 1, v, torch.bfloat16, sx=sx,
                                                         wk=wk),
                 lambda: ops.conv_i8(x8, w8, 1, 1, v, torch.bfloat16, sx, None, None, False, wk)),
                ("quant_i8", lambda: quant.quant_i8(xb, sx), lambda: ops.quant_i8(xb, sx, None)),
                ("maxpool2", lambda: cuda_pool.maxpool2_forward(xb), lambda: ops.maxpool2(xb))):
            a = [host_us(direct), host_us(op), host_us(direct), host_us(op)]
            phase("tools", f"{label} at 8x14x14x256 ({power}): host us a call, the wrapper "
                  f"{a[0]:.1f} / {a[2]:.1f}, the mgtpu:: op {a[1]:.1f} / {a[3]:.1f} (in turns)")


def check_tools(name, power) -> dict:
    """30: the tools on the card. model_info's two counts for R-MG-34; the
    host cost of the kernels as mgtpu:: ops against their wrappers'
    direct calls (:func:`ops_host_cost`); R-MG-34 exported folded bf16
    and int8 static at batch TIME_BATCH with
    mgtpu_torch.tools.export_model's functions (the program's graph holds
    mgtpu:: ops), both served in one fresh process through serve_exported
    (no model code there): each one's outputs against Server.predict's on
    the same images from the server it was exported from (bf16: the same
    top-1 and within 1e-5 of the scale; int8: bit for bit), its launches
    per forward Server.predict's (PER_FORWARD, TOOLS_I8_PER_FORWARD), its
    median of TOOLS_WINDOWS windows alone, then beside Server.predict's
    in turns in that process once it has built the same server, the
    artifact's size; one bench_serving row per dtype at batch TIME_BATCH
    and bench_step_breakdown at TIME_BATCH. Returns the launches of the
    phase's runs, each as a counter read it: in this process the two
    servers' builds (the int8 one's calibration), the reference forwards,
    bench_serving's and bench_step_breakdown's; in the child every forward it ran (the
    programs' warm-up, counted and timed forwards, its servers' builds and
    calibration, their timed Server.predict calls)."""
    from mgtpu_torch.tools import bench_serving, bench_step_breakdown, export_model, model_info

    t_phase = time.perf_counter()
    info = model_info.model_info("ilsvrc/rnmg", 224, "cuda", depth=DEPTH, shortcutType="B")
    check(info["params"] == TOOLS_RMG34_PARAMS and info["macs_per_image"] == TOOLS_RMG34_MACS,
          f"model_info R-MG-34: {info}")
    phase("tools", f"model_info R-MG-{DEPTH} at 224 on {info['device']}: params "
          f"{info['params']:,}, macs_per_image {info['macs_per_image']:,} (the reference "
          f"formulation, the published count), macs_per_image_as_run "
          f"{info['macs_per_image_as_run']:,} (the convs the port runs: each exact-2x up "
          f"part as its 4x4/2 transposed conv)")
    ops_host_cost(power)
    kernels.reset_launches()
    launches = Counter()
    rng = np.random.default_rng(21)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xs = tmp / "images.npy"
        np.save(xs, rng.standard_normal((TIME_BATCH, *IMAGE_SHAPE), dtype=np.float32))
        np.save(tmp / "calib.npy", rng.standard_normal((CALIB_BATCH, *IMAGE_SHAPE),
                                                       dtype=np.float32))
        base = ["-netType", "ilsvrc/rnmg", "-depth", str(DEPTH), "-shortcutType", "B",
                "-batch", str(TIME_BATCH), "-imageCrop", str(IMAGE_SHAPE[0])]
        cases = {}
        for label, extra, pins in (("bf16", [], PER_FORWARD),
                                   ("int8 static", ["-int8", "-calib", str(tmp / "calib.npy")],
                                    TOOLS_I8_PER_FORWARD)):
            art = tmp / f"rmg34_{label.replace(' ', '_')}.pt2"
            flags = base + extra + ["-out", str(art)]
            server = export_model.build_server(export_model.parser().parse_args(flags))
            t0 = time.perf_counter()
            program = export_model.export(server, TIME_BATCH, IMAGE_SHAPE[0], IMAGE_SHAPE[2])
            program.example_inputs = None
            torch.export.save(program, str(art))
            ops = Counter(str(n.target) for n in program.graph.nodes
                          if str(n.target).startswith("mgtpu."))
            check(ops, f"{label}: the exported graph holds no mgtpu:: op")
            cases[label] = ({"art": str(art), "out": str(tmp / f"y_{len(cases)}.npy"),
                             "flags": flags}, server, pins, ops, time.perf_counter() - t0)
            del program
        alone, model_code, turns, child_launches, wall = serve_exported_child(
            xs, [c[0] for c in cases.values()])
        check(model_code == [], f"serve_exported imported model code: {model_code}")
        launches.update(child_launches)
        images = torch.from_numpy(np.load(xs)).cuda()
        for (label, (job, server, pins, ops, t_export)), child, pair in zip(
                cases.items(), alone, turns):
            check(child["launches"] == pins, f"{label}: the exported forward launched "
                  f"{child['launches']}, expected Server.predict's {pins}")
            y_ref = server.predict(images).float().cpu()
            y = torch.from_numpy(np.load(job["out"]))
            err, scale = (y - y_ref).abs().max().item(), y_ref.abs().max().item()
            same = torch.equal(y, y_ref)
            if label == "bf16":
                top1 = int((y.argmax(-1) == y_ref.argmax(-1)).sum())
                check(bool(torch.isfinite(y).all()) and top1 == TIME_BATCH
                      and err <= 1e-5 * scale, f"{label}: exported vs Server.predict max abs "
                      f"{err:.3g} (scale {scale:.4g}), top-1 agrees on {top1}/{TIME_BATCH}")
                gate = f"top-1 agrees on {top1}/{TIME_BATCH}, max abs {err:.3g} (bound 1e-5 x " \
                       f"{scale:.4g})"
            else:
                check(same, f"{label}: exported vs Server.predict differ, max abs {err:.3g}")
                gate = "bit for bit"
            size = Path(job["art"]).stat().st_size / 1e6
            phase("tools", f"R-MG-{DEPTH} {label}, BN folded, batch {TIME_BATCH}: exported in "
                  f"{t_export:.1f} s, {size:.1f} MB, the graph's ops {dict(ops)}; served by "
                  f"serve_exported in a fresh process (no model code; {wall:.1f} s for both "
                  f"programs, the turns with Server.predict included): {gate} against "
                  f"Server.predict ({'the same bits' if same else 'not the same bits'}); "
                  f"launches per forward {child['launches']}, designs {child['routes']}")
            phase("tools", f"R-MG-{DEPTH} {label} forward at batch {TIME_BATCH} on {name} "
                  f"({power}), host included, in the fresh process, medians of "
                  f"{TOOLS_WINDOWS} windows of {TOOLS_REPS}: the exported program alone "
                  f"{child['ms']:.3f} ms (spread {child['spread']:.1%}); in turns with "
                  f"Server.predict, the exported program {pair['ms'][0]:.3f} ms (spread "
                  f"{pair['ms'][1]:.1%}), Server.predict {pair['predict_ms'][0]:.3f} ms (spread "
                  f"{pair['predict_ms'][1]:.1%}); the program's window over the "
                  f"Server.predict window beside it: median {pair['ratio'][1]:.3f}, quartiles "
                  f"{pair['ratio'][0]:.3f} and {pair['ratio'][2]:.3f}")
        del cases, images, server
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_serving.main(["--int8", "--batches", str(TIME_BATCH)])
    rows = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    check(len(rows) == 2 and all(r["throughput_img_s"] > 0 for r in rows),
          f"bench_serving: {out.getvalue()[-800:]}")
    for r in rows:
        phase("tools", f"bench_serving {json.dumps(r)}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_step_breakdown.main([str(TIME_BATCH)])
    lines = out.getvalue().strip().splitlines()
    check(len(lines) == 6 and "full step" in lines[4], f"bench_step_breakdown: {lines}")
    for line in lines:
        phase("tools", f"bench_step_breakdown: {line}")
    launches.update(kernels.LAUNCHES)
    for k in ("conv3x3", "conv3x3_bn_relu_in", "maxpool2", "maxpool2_bwd", "conv_i8",
              "quant_i8"):
        check(launches[k] > 0, f"{k} never launched in phase 30: {dict(launches)}")
    phase("tools", f"phase 30 took {time.perf_counter() - t_phase:.1f} s; launches "
          f"{dict(launches)} (the child's {child_launches})")
    return dict(launches)


def fmt(metrics) -> str:
    return ", ".join(f"{k} {v:.5f}" for k, v in metrics.items())



# 31: the mesh's second axis (-spatial, -tensor)
AXIS_MODES = {"spatial": "model", "tensor": "tensor"}
AXIS_BATCH, AXIS_F32_BATCH, AXIS_STEPS = 128, 8, 3


def axis_pins(train_shapes, mode) -> tuple[dict, dict]:
    """A rank's predicted (designs, halo-mode launches) per R-MG-34
    training step under ``mode`` with two model ranks, from one rank's
    recorded conv shapes (H, W, Ci, Co): under -spatial the same designs
    (a slab keeps its channels), each launch at a height spatial_split
    splits in halo mode; under -tensor no halo mode, and each conv's Co
    halved where tp_spec slices it."""
    from mgtpu_torch.parallel import spatial_split, tp_spec

    shapes = {k: Counter(v) for k, v in train_shapes.items()}
    padded = dict.fromkeys(kernels.PADDED, 0)
    if mode == "tensor":
        for k in ("conv3x3", "conv3x3_bn_relu_in"):
            shapes[k] = Counter({(h, w, ci, co // 2 if tp_spec((co,), 2) else co): n
                                 for (h, w, ci, co), n in shapes[k].items()})
    routes = predicted_routes(shapes)
    if mode == "spatial":
        for k in ("conv3x3", "conv3x3_bn_relu_in"):
            for (h, w, ci, co), n in shapes[k].items():
                if spatial_split(h, 2):
                    x = torch.empty((1, h, w, ci), dtype=torch.bfloat16)
                    wt = torch.empty((3, 3, ci, co), dtype=torch.bfloat16)
                    padded[(k, cuda_conv._route(x, wt))] += n
    return routes, padded


def halo_work(kernel, shape, batch, itemsize=2):
    """(operations, bytes) of rank 0's halo-mode launch under -spatial 2
    at a recorded whole-image shape (H, W, Ci, Co): H/2 output rows from
    H/2 + 1 input rows (the halo row below; the zero pad above), each
    input read once, each output written once, multiply-adds on the taps
    inside x (3 * H/2 - 1 along H, 3W - 2 along W)."""
    h, w, ci, co = shape
    hl = h // 2
    nbytes = itemsize * (batch * (hl + 1) * w * ci + 9 * ci * co + batch * hl * w * co) + 4 * co
    if kernel == "conv3x3_bn_relu_in":
        nbytes += 8 * ci
    return 2 * batch * (3 * hl - 1) * (3 * w - 2) * ci * co, nbytes


def time_halo(train_shapes) -> dict:
    """Rank 0's halo-mode launches of one R-MG-34 training step under
    -spatial 2 at AXIS_BATCH (the recorded shapes at the heights
    spatial_split splits, H/2 + 1 input rows, pads (1, 0)): each held
    against its plain version on the same slab, then timed in turns with
    the plain version, the whole-image launch at the same shape and, for
    conv3x3, one PyTorch call: F.conv2d with padding 1 on the slab, its
    last output row (the zero pad's, below the halo row) dropped as a view
    (device_ms). Returns {kernel: launches, ms, plain_ms, whole_ms,
    library_ms (None for the prologue), max_abs_err, bound_ms, bound_by},
    the times summed over the step."""
    from mgtpu_torch.parallel import spatial_split

    out = {}
    for k, fn, plain in (("conv3x3", conv3x3, conv3x3_plain),
                         ("conv3x3_bn_relu_in", conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain)):
        tot = dict(launches=0, ms=0.0, plain_ms=0.0, whole_ms=0.0, max_abs_err=0.0, flops=0,
                   nbytes=0, library_ms=0.0 if k == "conv3x3" else None)
        for i, ((h, w, ci, co), n) in enumerate(sorted(train_shapes[k].items())):
            if not spatial_split(h, 2):
                continue
            x, wt, b = conv_inputs(AXIS_BATCH, h, w, ci, co, torch.bfloat16, seed=310 + i)
            vec = bn_inputs(ci, seed=320 + i) if k == "conv3x3_bn_relu_in" else ()
            xs = x[:, :h // 2 + 1].contiguous()
            y = fn(xs, wt, b, *vec, with_stats=False, pad_top=1, pad_bottom=0)[0]
            y_ref = plain(xs.float(), wt.float(), b, *vec, with_stats=False, pad_top=1,
                          pad_bottom=0)[0]
            torch.cuda.synchronize()
            err = float((y.float() - y_ref).abs().max())
            check(err <= 2.0 ** -7 * float(y_ref.abs().max()) + 1e-3,
                  f"{k} halo mode at {(AXIS_BATCH, h // 2 + 1, w, ci, co)}: max abs err {err:.3g}")
            fns = [lambda: fn(xs, wt, b, *vec, with_stats=False, pad_top=1, pad_bottom=0),
                   lambda: plain(xs, wt, b, *vec, with_stats=False, pad_top=1, pad_bottom=0),
                   lambda: fn(x, wt, b, *vec, with_stats=False)]
            if k == "conv3x3":
                w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                b_lib = b.to(xs.dtype)
                fns.append(lambda: F.conv2d(nchw(xs), w_lib, b_lib, padding=1)[:, :, :h // 2])
                y_lib = fns[-1]()
                check(tuple(y_lib.shape[2:]) == tuple(y.shape[1:3]),
                      f"conv3x3 halo mode's PyTorch call gives {tuple(y_lib.shape)}")
            times = device_ms(fns, windows=3)
            (t, _), (tp, _), (tw, _) = times[:3]
            if k == "conv3x3":
                tot["library_ms"] += n * times[3][0]
            flops, nbytes = halo_work(k, (h, w, ci, co), AXIS_BATCH)
            tot["launches"] += n
            tot["ms"] += n * t
            tot["plain_ms"] += n * tp
            tot["whole_ms"] += n * tw
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["flops"] += n * flops
            tot["nbytes"] += n * nbytes
            del x, xs, y, y_ref
        tot["bound_ms"], tot["bound_by"] = bound(tot["flops"], tot["nbytes"])
        out[k] = tot
    return out


def whole_export(mesh, model):
    """(params, stats) of ``model`` as whole JAX trees (gathered under
    -tensor; a collective)."""
    from mgtpu_torch.parallel import whole_tensors

    with whole_tensors(mesh, model):
        return export_jax_tree(model)


@contextlib.contextmanager
def axis_collectives(log: list):
    """Within it, each all-gather and all-reduce of the mesh's second axis
    (mgtpu_torch.parallel.axis) is synchronized and timed: ``log`` gets
    (kind, bytes, ms) for each, the kind of an int8 all-gather (conv_i8's
    halo rows) marked "all_gather int8"."""
    from mgtpu_torch.parallel import axis as pax

    gather, reduce = pax._all_gather, pax._all_reduce

    def timed(kind, fn, t, nbytes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log.append((kind, nbytes, (time.perf_counter() - t0) * 1e3))
        return out

    pax._all_gather = lambda t, group, n: timed(
        "all_gather" + (" int8" if t.dtype == torch.int8 else ""), lambda: gather(t, group, n), t,
        n * t.nbytes)
    pax._all_reduce = lambda t, group: timed("all_reduce", lambda: reduce(t, group), t, t.nbytes)
    try:
        yield
    finally:
        pax._all_gather, pax._all_reduce = gather, reduce


def axis_rank(rank, mode, init, out_dir) -> None:
    """One of phase 31's two ranks under ``mode``, a spawned process on
    cuda:0 joined over gloo: one f32 step of R-MG-34 on the global batch
    of AXIS_F32_BATCH (rank 0 writes the whole state), then AXIS_STEPS
    bf16 steps at AXIS_BATCH with the counts set to 0 just before each and
    read just after, the leaves kept whole held the same bits on both
    ranks after each, the peak memory, and one more step with the axis's
    collectives timed. Writes out_dir/<mode><rank>.json."""
    import torch.distributed as dist

    from mgtpu_torch.parallel import make_mesh, same_bits
    from mgtpu_torch.parallel.axis import sliced

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, rank=rank, device="cuda:0", init_method=init, backend="gloo",
                     n_model=2, model_axis=AXIS_MODES[mode])
    try:
        x, y = synthetic_batch(AXIS_F32_BATCH, seed=11)
        tr = Trainer(RMG34, seed=0, device="cuda:0", compute_dtype=torch.float32, mesh=mesh)
        before, _ = whole_export(mesh, tr.model)
        loss = float(tr.step(x, y, 0.1, 1e-4)["loss"])
        p, st = whole_export(mesh, tr.model)
        if rank == 0:
            np.savez(Path(out_dir) / f"{mode}.npz", loss=loss, **{
                f"{k}/{i}": a for k, tree in zip("bps", (before, p, st))
                for i, a in enumerate(flat(tree))})
        del tr
        torch.cuda.empty_cache()
        x, y = synthetic_batch(AXIS_BATCH, seed=12)
        tr = Trainer(RMG34, seed=0, device="cuda:0", compute_dtype=torch.bfloat16, mesh=mesh)
        lr, wd = TRAIN_RULE["lr"], TRAIN_RULE["wd"]
        kept = ([q for q in tr.model.parameters() if not sliced(q)]
                + [m for q, m in zip(tr.model.parameters(), tr.opt_state["m"]) if not sliced(q)]
                + [b for b in tr.model.buffers() if not sliced(b)])
        losses, bits, step_ms = [], [], []
        launches, routes, padded = Counter(), Counter(), Counter()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(AXIS_STEPS):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(tr.step(x, y, lr, wd)["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.update(kernels.LAUNCHES)
            routes.update({f"{k}/{r}": n for (k, r), n in kernels.ROUTES.items()})
            padded.update({f"{k}/{r}": n for (k, r), n in kernels.PADDED.items()})
            bits.append(same_bits(mesh, kept))
        peak = torch.cuda.max_memory_allocated()
        log = []
        with axis_collectives(log):
            tr.step(x, y, lr, wd)
        (Path(out_dir) / f"{mode}{rank}.json").write_text(json.dumps({
            "losses": losses, "bits": bits, "step_ms": step_ms, "launches": dict(launches),
            "routes": dict(routes), "padded": dict(padded), "peak": peak,
            "collectives": log, "held_bytes": sum(q.nbytes for q in tr.model.parameters())}))
    finally:
        dist.destroy_process_group()


def check_axis(name, power, train_shapes) -> dict:
    """31: R-MG-34 under -spatial 2 and -tensor 2 (see the module's
    head). Returns the ranks' bf16 launches, summed."""
    import torch.multiprocessing as mp

    from mgtpu_torch.main import free_port

    t_phase = time.perf_counter()
    x, y = synthetic_batch(AXIS_F32_BATCH, seed=11)
    one = dp_step(Trainer(RMG34, seed=0, device="cuda", compute_dtype=torch.float32), x, y,
                  0.1, 1e-4)
    torch.cuda.empty_cache()
    xb, yb = synthetic_batch(AXIS_BATCH, seed=12)
    tr = Trainer(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    rule = TRAIN_RULE
    tr.step(xb, yb, rule["lr"], rule["wd"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    float(tr.step(xb, yb, rule["lr"], rule["wd"])["loss"])
    one_ms = (time.perf_counter() - t0) * 1e3
    one_peak = torch.cuda.max_memory_allocated()
    one_bytes = sum(q.nbytes for q in tr.model.parameters())
    del tr
    torch.cuda.empty_cache()
    total = Counter()
    for mode, axis_name in AXIS_MODES.items():
        t_mode = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(axis_rank, args=(mode, f"tcp://127.0.0.1:{free_port()}", tmp),
                               nprocs=2, start_method="spawn")
            got = np.load(Path(tmp) / f"{mode}.npz")
            ranks = [json.loads((Path(tmp) / f"{mode}{r}.json").read_text()) for r in (0, 1)]
        res = {"cuda": (float(got["loss"]), *({f"{i:06d}": got[f"{k}/{i}"]
                                                for i in range(len(flat(tree)))}
                                               for k, tree in zip("bps", one[1:]))),
               "cpu": one}
        loss_err, upd, st = step_error(res)
        check(loss_err <= 1e-5 and upd <= F32_STEP_PARAM_BOUND and st <= F32_STEP_STATS_BOUND,
              f"R-MG-{DEPTH} f32 step under -{mode} 2 vs one rank on the card: loss err "
              f"{loss_err:.3g} (bound 1e-5), update err {upd:.3g} (bound "
              f"{F32_STEP_PARAM_BOUND}), stats err {st:.3g} (bound {F32_STEP_STATS_BOUND})")
        phase("axis", f"R-MG-{DEPTH} f32 at global batch {AXIS_F32_BATCH}, -{mode} 2 ('"
              f"{axis_name}' axis; two ranks on one card, gloo) vs one rank on the card: loss "
              f"{res['cuda'][0]:.6f} vs {one[0]:.6f} (err {loss_err:.3g}, bound 1e-5); update "
              f"err {upd:.3g} of its L2 norm (bound {F32_STEP_PARAM_BOUND}); running stats err "
              f"{st:.3g} of their scale (bound {F32_STEP_STATS_BOUND})")
        routes, padded = axis_pins(train_shapes, mode)
        want = {k: AXIS_STEPS * n for k, n in PER_STEP.items() if n}
        want_routes = {f"{k}/{r}": AXIS_STEPS * n for (k, r), n in routes.items() if n}
        want_padded = {f"{k}/{r}": AXIS_STEPS * n for (k, r), n in padded.items() if n}
        for r, rk in enumerate(ranks):
            check(all(np.isfinite(rk["losses"])) and rk["losses"][-1] < rk["losses"][0]
                  and rk["losses"] == ranks[0]["losses"]
                  and all(rk["bits"]), f"-{mode} rank {r}: losses {rk['losses']} (rank 0 "
                  f"{ranks[0]['losses']}), the leaves kept whole the same bits: {rk['bits']}")
            got_launches = {k: n for k, n in rk["launches"].items() if n}
            check(got_launches == want, f"-{mode} rank {r}: launches {got_launches} in "
                  f"{AXIS_STEPS} steps, expected {want}")
            got_routes = {k: n for k, n in rk["routes"].items() if n}
            got_padded = {k: n for k, n in rk["padded"].items() if n}
            check(got_routes == want_routes and got_padded == want_padded,
                  f"-{mode} rank {r}: designs {got_routes}, expected {want_routes}; halo-mode "
                  f"launches {got_padded}, expected {want_padded}")
            total.update(rk["launches"])
        med = [statistics.median(rk["step_ms"][1:]) for rk in ranks]
        coll = {}
        for kind, nbytes, ms in ranks[0]["collectives"]:
            c = coll.setdefault(kind, [0, 0, 0.0])
            c[0], c[1], c[2] = c[0] + 1, c[1] + nbytes, c[2] + ms
        phase("axis", f"R-MG-{DEPTH} bf16, global batch {AXIS_BATCH}, -{mode} 2, "
              f"{AXIS_STEPS} steps at lr {TRAIN_RULE['lr']:g}: losses "
              + ", ".join(f"{v:.4f}" for v in ranks[0]["losses"])
              + f"; the leaves kept whole the same bits on both ranks after every step; "
              f"launches per rank {want}, designs {want_routes}, halo mode {want_padded or 0}")
        phase("axis", f"times on {power} (gloo, two ranks sharing one card: not scaling): a "
              f"rank's step {med[0]:.1f} / {med[1]:.1f} ms (median of steps 2-{AXIS_STEPS}, host "
              f"clock to the loss read), one rank's step {one_ms:.1f} ms; the axis's "
              f"collectives in one step of rank 0 (each synchronized): "
              + "; ".join(f"{n} {kind}s, {b / 1e6:.1f} MB, {ms:.1f} ms"
                          for kind, (n, b, ms) in coll.items())
              + f"; peak memory a rank {ranks[0]['peak'] / 2**30:.2f} / "
              f"{ranks[1]['peak'] / 2**30:.2f} GiB, one rank {one_peak / 2**30:.2f} GiB; "
              f"parameters held a rank {ranks[0]['held_bytes'] / 1e6:.1f} MB, one rank "
              f"{one_bytes / 1e6:.1f} MB; -{mode} took {time.perf_counter() - t_mode:.1f} s")
    halo = time_halo(train_shapes)
    for k, t in halo.items():
        phase("axis", f"{k} in halo mode, rank 0's {t['launches']} launches of one R-MG-{DEPTH} "
              f"step under -spatial 2 at batch {AXIS_BATCH} (H/2 + 1 rows, pads (1, 0)), on "
              f"{power}: {t['flops'] / 1e9:.1f} GFLOP, {t['nbytes'] / 1e6:.1f} MB, bound "
              f"{t['bound_ms']:.4f} ms (by {t['bound_by']}); kernel {t['ms']:.3f} ms "
              f"({t['bound_ms'] / t['ms']:.0%} of the bound), plain {t['plain_ms']:.3f} ms, the "
              f"whole-image launches at the same shapes {t['whole_ms']:.3f} ms, one PyTorch "
              f"call " + ("none" if t["library_ms"] is None else
                          f"(F.conv2d, padding 1, its last row dropped) {t['library_ms']:.3f} ms")
              + f"; max abs err vs plain {t['max_abs_err']:.3g}")
    phase("axis", f"phase 31 took {time.perf_counter() - t_phase:.1f} s")
    return dict(total), halo


# 32: int8 serving across ranks (the dynamic scale over the mesh; -spatial
# under -int8)
I8_AXIS_MESHES = {"spatial": (1, 2), "data": (2, 1)}  # name -> (data ranks, model ranks)
I8_AXIS_MODES = {"spatial": ("static", "dynamic"), "data": ("dynamic",)}
I8_AXIS_BATCH, I8_AXIS_REPS = 128, 3
# conv_i8's halo-mode pads phase 32 holds each design to: a 3x3/s1 part's
# slab at the image's top, at its bottom, inside; the 7x7/2 stem's (3
# rows above, 2 below: axis.window_rows(7, 2, 3))
I8_HALO_PADS = {(3, 1, 1): [(1, 0), (0, 1), (0, 0)], (7, 2, 3): [(3, 0), (0, 2), (0, 0)]}


def i8_split(key) -> bool:
    """Whether an R-MG-34 int8 forward's recorded conv_i8 call runs in
    halo mode under -spatial 2: its height split (spatial_split), its
    window reaching past its rows (k > 1)."""
    from mgtpu_torch.parallel import spatial_split

    return spatial_split(key[0], 2) and key[4] > 1


def i8_slab(key, rows, pads):
    """(input rows, output rows) of the slab of a split conv_i8 call whose
    output rows are ``rows`` (r0, r1) of the whole image's, under
    ``pads``: the rows its window reads, the halo's included."""
    from mgtpu_torch.parallel.axis import window_rows

    h, k, s, p = key[0], key[4], key[5], key[6]
    top, bottom = window_rows(k, s, p)
    r0, r1 = rows
    return (0 if pads[0] else r0 * s - top, h if pads[1] else r1 * s + bottom), rows


def i8_slabs(key):
    """{pads: (input rows, output rows)} of I8_HALO_PADS' slabs of a split
    call: the top half, the bottom half, the middle half."""
    oh = cuda_conv_i8.out_size(key[0], key[4], key[5], key[6])
    q = oh // 4
    rows = {0: (0, oh // 2), 1: (oh // 2, oh), 2: (q, oh - q)}
    return {pads: i8_slab(key, rows[i], pads)
            for i, pads in enumerate(I8_HALO_PADS[tuple(key[4:7])])}


def i8_axis_epilogue(key, batch, oh, ow, seed):
    """The bf16 epilogue operands of a recorded conv_i8 call: a part sum
    where it takes one, a bias where it takes one, no ReLU (the part
    sums' launches take none; the checks cover it in phase 23)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    co = key[3]
    y_in = (torch.randn((batch, oh, ow, co), generator=g, device="cuda").to(torch.bfloat16)
            if key[9] else None)
    bias = torch.randn(co, generator=g, device="cuda") if key[10] else None
    return y_in, bias


def check_i8_halo(shapes, batch=CHECK_BATCH) -> tuple[int, Counter]:
    """32, the kernel: every recorded R-MG-34 int8 conv_i8 call that runs
    in halo mode under -spatial 2 (i8_split), at ``batch``: each slab of
    I8_HALO_PADS through the design _route picks and, where that is not
    simple, through simple too, bit for bit the whole image's launch (same
    design) at its rows, in int32 and in the bf16 epilogue of its call;
    the whole image's (pad, pad) launches bit for bit the plain version;
    each slab's launch counted in kernels.PADDED. Returns (cases, cases by
    design)."""
    designs, n_cases = Counter(), 0
    for i, key in enumerate(sorted(k for k in shapes if i8_split(k))):
        x8, w8, wk, v, sx = i8_operands(key, batch, seed=3200 + i)
        h, w, ci, co, k, s, p = key[:7]
        oh, ow = cuda_conv_i8.out_size(h, k, s, p), cuda_conv_i8.out_size(w, k, s, p)
        y0, bias = i8_axis_epilogue(key, batch, oh, ow, seed=3300 + i)
        acc_plain = cuda_conv_i8.conv_i8_plain(x8, w8, s, p)
        route = cuda_conv_i8._route(x8, w8, s, p, wk)
        fns = {route: lambda x, **kw: cuda_conv_i8.conv_i8(x, w8, s, p, wk=wk, **kw)}
        if route != "simple":
            fns["simple"] = lambda x, **kw: cuda_conv_i8._simple_forward(x, w8, s, p, **kw)
        for design, fn in fns.items():
            epi = dict(v=v, dtype=torch.bfloat16, sx=sx, bias=bias)
            acc = fn(x8)
            y = fn(x8, y_in=None if y0 is None else y0.clone(), **epi)
            check(torch.equal(acc, acc_plain) and torch.equal(y, cuda_conv_i8.epilogue_plain(
                acc_plain, v, torch.bfloat16, sx=sx, y_in=None if y0 is None else y0.clone(),
                bias=bias)), f"conv_i8 {batch}x{key} (pad, pad) through {design} differs from "
                f"the plain version")
            for pads, ((a, b), (r0, r1)) in i8_slabs(key).items():
                xs = x8[:, a:b].contiguous()
                before = dict(kernels.PADDED)
                acc_s = fn(xs, pad_top=pads[0], pad_bottom=pads[1])
                y_s = fn(xs, pad_top=pads[0], pad_bottom=pads[1],
                         y_in=None if y0 is None else y0[:, r0:r1].contiguous(), **epi)
                halo = pads != (p, p)
                got_padded = kernels.PADDED[("conv_i8", design)] - before[("conv_i8", design)]
                check(got_padded == 2 * halo, f"conv_i8 {key} pads {pads} through {design}: "
                      f"{got_padded} halo-mode launches counted, expected {2 * halo}")
                check(torch.equal(acc_s, acc[:, r0:r1]) and torch.equal(y_s, y[:, r0:r1]),
                      f"conv_i8 {batch}x{key} slab {a}:{b} pads {pads} through {design}: not "
                      f"the whole image's rows {r0}:{r1} bit for bit")
                designs[design] += 2
                n_cases += 2
    torch.cuda.synchronize()
    return n_cases, designs


def time_i8_halo(shapes) -> dict:
    """32, the kernel's times: rank 0's halo-mode conv_i8 launches of one
    R-MG-34 int8 forward under -spatial 2 at I8_AXIS_BATCH (each recorded
    call that i8_split selects: the top half's slab, pads (top, 0)),
    checked once bit for bit against the whole image's launch at its
    rows and its plain version, then timed in turns with the plain version
    on the same slab and the whole image's launch at the recorded shape
    (device_ms). Returns {launches, ms, plain_ms, whole_ms, max_abs_err,
    bound_ms, bound_by, ops, nbytes}, the times summed over the forward."""
    tot = dict(launches=0, ms=0.0, plain_ms=0.0, whole_ms=0.0, max_abs_err=0.0, ops=0, nbytes=0,
               bound_ms=0.0)
    ops_ms = 0.0  # the part of the bound that operations set
    for i, (key, n) in enumerate(sorted(shapes.items())):
        if not i8_split(key):
            continue
        x8, w8, wk, v, sx = i8_operands(key, I8_AXIS_BATCH, seed=3400 + i)
        h, w, ci, co, k, s, p = key[:7]
        pads, ((a, b), (r0, r1)) = next(iter(i8_slabs(key).items()))
        xs = x8[:, a:b].contiguous()
        oh, ow = cuda_conv_i8.out_size(h, k, s, p), cuda_conv_i8.out_size(w, k, s, p)
        y0, bias = i8_axis_epilogue(key, I8_AXIS_BATCH, oh, ow, seed=3500 + i)
        ys0 = None if y0 is None else y0[:, r0:r1].contiguous()
        epi = dict(v=v, dtype=torch.bfloat16, sx=sx, bias=bias)
        kw = dict(pad_top=pads[0], pad_bottom=pads[1])
        y_s = cuda_conv_i8.conv_i8(xs, w8, s, p, wk=wk, y_in=None if ys0 is None else ys0.clone(),
                                   **kw, **epi)
        y = cuda_conv_i8.conv_i8(x8, w8, s, p, wk=wk, y_in=None if y0 is None else y0.clone(),
                                 **epi)
        y_p = cuda_conv_i8.conv_i8_plain(xs, w8, s, p, y_in=None if ys0 is None else ys0.clone(),
                                         **kw, **epi)
        torch.cuda.synchronize()
        err = (y_s.double() - y_p.double()).abs().max().item()
        check(torch.equal(y_s, y[:, r0:r1]) and torch.equal(y_s, y_p),
              f"conv_i8 {I8_AXIS_BATCH}x{key} halo mode {pads}: not the whole image's rows and "
              f"the plain version's (max abs err {err:.3g})")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        (t, _), (tp, _), (tw, _) = device_ms([
            lambda: cuda_conv_i8.conv_i8(xs, w8, s, p, wk=wk, y_in=ys0, **kw, **epi),
            lambda: cuda_conv_i8.conv_i8_plain(xs, w8, s, p, y_in=None if ys0 is None
                                               else ys0.clone(), **kw, **epi),
            lambda: cuda_conv_i8.conv_i8(x8, w8, s, p, wk=wk, y_in=y0, **epi)], windows=3)
        slab_key = (b - a, *key[1:])
        ops, nbytes = i8_work(slab_key, I8_AXIS_BATCH, pads=pads)
        t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        tot["launches"] += n
        tot["ms"] += n * t
        tot["plain_ms"] += n * tp
        tot["whole_ms"] += n * tw
        tot["ops"] += n * ops
        tot["nbytes"] += n * nbytes
        tot["bound_ms"] += n * max(t_ops, t_bytes)
        ops_ms += n * t_ops * (t_ops > t_bytes)
        del x8, xs, y, y_s, y_p, y0, ys0
    tot["bound_by"] = "operations" if tot["bound_ms"] and 2 * ops_ms >= tot["bound_ms"] else "bytes"
    return tot


@contextlib.contextmanager
def dynamic_scales(out: list):
    """Within it, the layers' dynamic activation scales (0-d f32 on the
    card, in call order) go to ``out``; no synchronization."""
    original = quant.quant_i8_group

    def fn(members):
        res = original(members)
        out.extend(s.reshape(()) for (_, s), (_, sx, _) in zip(res, members) if sx is None)
        return res

    quant.quant_i8_group = fn
    try:
        yield out
    finally:
        quant.quant_i8_group = original


@contextlib.contextmanager
def timed_reduces(log: list):
    """Within it, each all-reduce of a dynamic scale over the mesh
    (quant.mesh_absmax) is synchronized and timed: ``log`` gets its ms."""
    original = quant.mesh_absmax

    def fn(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(t)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0) * 1e3)
        return out

    quant.mesh_absmax = fn
    try:
        yield log
    finally:
        quant.mesh_absmax = original


def i8_axis_forwards(server, mesh, x, y) -> dict:
    """Phase 32's forwards of ``server``'s int8 R-MG-34 through the run
    loop's eval step on ``mesh`` (None: one rank) and this rank's rows of
    the global batch (x, y), in each mode of the mesh's (static: the
    server's calibrated scales; dynamic: none): one to warm up, then one
    with the counts set to 0 just before and read just after, whose
    outputs and dynamic scales are kept; I8_AXIS_REPS timed (host clock
    to the synchronized output); one with each scale all-reduce timed;
    one with the mesh's collectives timed (axis_collectives). Returns
    {mode: results}."""
    from mgtpu_torch.parallel import shard_batch
    from mgtpu_torch.train.step import make_eval_step

    spec = get_spec("ilsvrc/rnmg")
    step = make_eval_step(server.model, spec.create_loss(server.opt), spec, "test", mesh)
    convs = [m for m in server.model.modules() if getattr(m, "quantized", False)]
    calibrated = [m.sx for m in convs]
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    if mesh is not None:
        batch = shard_batch(mesh, batch, 0, spatial=True)
    batch = {k: v.to(server.device) for k, v in batch.items()}
    name = "one" if mesh is None else "data" if mesh.n_model == 1 else "spatial"
    res = {}
    for mode in I8_AXIS_MODES["spatial" if mesh is None else name]:
        for m, sx in zip(convs, calibrated):
            m.sx = sx if mode == "static" else None
        step(batch)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with dynamic_scales([]) as scales:
            out = step(batch)[1]
        launches = dict(kernels.LAUNCHES)
        routes = {f"{k}/{r}": n for (k, r), n in kernels.ROUTES.items() if n}
        padded = {f"{k}/{r}": n for (k, r), n in kernels.PADDED.items() if n}
        torch.cuda.synchronize()
        fwd_ms = []
        for _ in range(I8_AXIS_REPS):
            t0 = time.perf_counter()
            step(batch)[1].float().sum().item()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        reduces, coll = [], []
        if mesh is not None:
            with timed_reduces(reduces):
                step(batch)
            with axis_collectives(coll):
                step(batch)
        res[mode] = {"out": out.float().cpu().numpy(),
                     "scales": (torch.stack(scales).cpu().numpy() if scales
                                else np.zeros(0, np.float32)),
                     "launches": launches, "routes": routes, "padded": padded,
                     "fwd_ms": fwd_ms, "reduces": reduces, "collectives": coll}
    for m, sx in zip(convs, calibrated):
        m.sx = sx
    return res


def i8_axis_rank(rank, name, init, out_dir) -> None:
    """One of phase 32's two ranks of mesh ``name`` (I8_AXIS_MESHES), a
    spawned process on cuda:0 joined over gloo: R-MG-34 served under
    int8 as phase 24 builds it (Server: BN folded, quantized, calibrated
    on I8_CALIB batches), its forwards on the rank's rows of the global
    batch (i8_axis_forwards). Writes out_dir/<name><rank>.npz and .json."""
    import torch.distributed as dist

    from mgtpu_torch.parallel import make_mesh

    n_data, n_model = I8_AXIS_MESHES[name]
    mesh = make_mesh(n_data, rank=rank, device="cuda:0", init_method=init, backend="gloo",
                     n_model=n_model)
    try:
        server = Server(RMG34, seed=0, device="cuda:0", compute_dtype=torch.bfloat16, int8=True,
                        int8_calib=I8_CALIB)
        sx = torch.cat([m.sx for m in server.model.modules() if getattr(m, "quantized", False)])
        res = i8_axis_forwards(server, mesh, *synthetic_batch(I8_AXIS_BATCH, seed=32))
        np.savez(Path(out_dir) / f"{name}{rank}.npz", sx=sx.cpu().numpy(), **{
            f"{mode}/{k}": r[k] for mode, r in res.items() for k in ("out", "scales")})
        (Path(out_dir) / f"{name}{rank}.json").write_text(json.dumps({
            mode: {k: v for k, v in r.items() if k not in ("out", "scales")}
            for mode, r in res.items()}))
    finally:
        dist.destroy_process_group()


def check_i8_axis(name, power, shapes) -> tuple[dict, dict]:
    """32: int8 serving across ranks (see the module's head). Returns (the
    ranks' counted launches, summed; conv_i8's halo_mode numbers)."""
    import torch.multiprocessing as mp

    from mgtpu_torch.main import free_port

    t_phase = time.perf_counter()
    n_cases, designs = check_i8_halo(shapes)
    phase("i8 axis", f"conv_i8 in halo mode: {n_cases} launches ({dict(designs)} by design) at "
          f"the {sum(1 for k in shapes if i8_split(k))} recorded R-MG-{DEPTH} int8 calls split "
          f"under -spatial 2, batch {CHECK_BATCH} (3x3/s1 slabs with pads (1, 0), (0, 1), "
          f"(0, 0); the 7x7/2 stems' with (3, 0), (0, 2), (0, 0); int32 and the call's bf16 "
          f"epilogue), each bit for bit the whole image's launch through the same design at "
          f"its rows, and counted in kernels.PADDED; the whole image's (pad, pad) launches bit "
          f"for bit the plain version")
    server = Server(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16, int8=True,
                    int8_calib=I8_CALIB)
    sx_one = torch.cat([m.sx for m in server.model.modules()
                        if getattr(m, "quantized", False)]).cpu().numpy()
    x, y = synthetic_batch(I8_AXIS_BATCH, seed=32)
    one = i8_axis_forwards(server, None, x, y)
    del server
    torch.cuda.empty_cache()
    padded_pin = {f"conv_i8/{d}": n for d, n in i8_routes(
        {k: n for k, n in shapes.items() if i8_split(k)}).items() if n}
    total = Counter()
    for mesh_name, (n_data, n_model) in I8_AXIS_MESHES.items():
        t_mesh = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(i8_axis_rank, args=(mesh_name, f"tcp://127.0.0.1:{free_port()}",
                                                   tmp), nprocs=n_data * n_model,
                               start_method="spawn")
            ranks = [(dict(np.load(Path(tmp) / f"{mesh_name}{r}.npz")),
                      json.loads((Path(tmp) / f"{mesh_name}{r}.json").read_text()))
                     for r in range(n_data * n_model)]
        for r, (arrays, info) in enumerate(ranks):
            check(np.array_equal(arrays["sx"], sx_one), f"-{mesh_name} rank {r}: the calibrated "
                  f"scales differ from the one-rank calibration's")
            for mode, rk in info.items():
                want = i8_pins("ilsvrc/rnmg", dynamic=mode == "dynamic")
                got = {k: n for k, n in rk["launches"].items() if n}
                check(got == {k: n for k, n in want.items() if n},
                      f"-{mesh_name} rank {r} {mode}: launches {got}, expected {want}")
                want_routes = {f"conv_i8/{d}": n for d, n in I8_ROUTES["ilsvrc/rnmg"].items()
                               if n}
                got_routes = {k: n for k, n in rk["routes"].items() if k.startswith("conv_i8")}
                want_padded = padded_pin if n_model > 1 else {}
                check(got_routes == want_routes and rk["padded"] == want_padded,
                      f"-{mesh_name} rank {r} {mode}: conv_i8 designs {got_routes}, expected "
                      f"{want_routes}; halo-mode launches {rk['padded']}, expected {want_padded}")
                total.update(rk["launches"])
                n_red = I8_PER_FORWARD["ilsvrc/rnmg"]["quant_i8"] if mode == "dynamic" else 0
                check(len(rk["reduces"]) == n_red, f"-{mesh_name} rank {r} {mode}: "
                      f"{len(rk['reduces'])} scale all-reduces in a forward, expected {n_red} "
                      f"(one a layer)")
                ref = one[mode]
                scales = arrays[f"{mode}/scales"]
                bad = (int((scales != ref["scales"]).sum()) if scales.shape == ref["scales"].shape
                       else "all")
                check(np.array_equal(scales, ref["scales"]), f"-{mesh_name} rank {r} {mode}: "
                      f"{bad} of {ref['scales'].size} dynamic scales differ from the one-rank "
                      f"forward's")
                out = arrays[f"{mode}/out"]
                rows = ref["out"][(r // n_model) * len(out):(r // n_model + 1) * len(out)]
                err, scale = float(np.abs(out - rows).max()), float(np.abs(rows).max())
                if n_data == 1:  # the same batch: every op exact or elementwise
                    check(np.array_equal(out, rows), f"-{mesh_name} rank {r} {mode}: outputs "
                          f"differ from the one-rank forward's (max abs {err:.3g})")
                else:  # the classifier's matmul at another batch
                    check(err <= 1e-5 * scale, f"-{mesh_name} rank {r} {mode}: outputs {err:.3g} "
                          f"from the one-rank forward's rows (bound 1e-5 x {scale:.4g})")
        for mode in I8_AXIS_MODES[mesh_name]:
            rk = [info[mode] for _, info in ranks]
            coll = {}
            for kind, nbytes, ms in rk[0]["collectives"]:
                c = coll.setdefault(kind, [0, 0, 0.0])
                c[0], c[1], c[2] = c[0] + 1, c[1] + nbytes, c[2] + ms
            red = rk[0]["reduces"]
            phase("i8 axis", f"R-MG-{DEPTH} int8 {mode}, -{mesh_name} 2 ({n_data} x {n_model}; "
                  f"two ranks on one card, gloo), global batch {I8_AXIS_BATCH}: "
                  + ("outputs bit for bit the one-rank int8 forward's" if n_data == 1 else
                     "each rank's rows within 1e-5 of the outputs' scale of the one-rank "
                     "forward's")
                  + (f"; all {len(one[mode]['scales'])} dynamic scales bit for bit the one-rank "
                     f"forward's on both ranks" if mode == "dynamic" else
                     "; the calibrated scales the same bits on both ranks and one")
                  + f"; launches a rank {i8_pins('ilsvrc/rnmg', dynamic=mode == 'dynamic')}, "
                  f"designs {I8_ROUTES['ilsvrc/rnmg']}, halo mode "
                  f"{padded_pin if n_model > 1 else 0}")
            phase("i8 axis", f"times on {power} (two ranks sharing one card: not scaling): a "
                  f"rank's forward {statistics.median(rk[0]['fwd_ms']):.1f} / "
                  f"{statistics.median(rk[1]['fwd_ms']):.1f} ms (median of {I8_AXIS_REPS}, host "
                  f"clock to the synchronized output), one rank's "
                  f"{statistics.median(one[mode]['fwd_ms']):.1f} ms; "
                  + (f"{len(red)} scale all-reduces in rank 0's forward (one a layer), "
                     f"{sum(red):.1f} ms "
                     f"(each synchronized, median {statistics.median(red):.3f} ms)"
                     if red else "no scale all-reduce (static scales)")
                  + "; the mesh's collectives in one forward of rank 0 (each synchronized): "
                  + ("; ".join(f"{n} {kind}s, {b / 1e6:.2f} MB, {ms:.1f} ms"
                               for kind, (n, b, ms) in coll.items()) or "none"))
        phase("i8 axis", f"-{mesh_name} took {time.perf_counter() - t_mesh:.1f} s")
    halo = time_i8_halo(shapes)
    phase("i8 axis", f"conv_i8 in halo mode, rank 0's {halo['launches']} launches of one "
          f"R-MG-{DEPTH} int8 forward under -spatial 2 at batch {I8_AXIS_BATCH} (the top "
          f"half's slabs), on {power}: {halo['ops'] / 1e9:.1f} GOP, {halo['nbytes'] / 1e6:.1f} "
          f"MB, bound {halo['bound_ms']:.4f} ms (by {halo['bound_by']}); kernel "
          f"{halo['ms']:.3f} ms ({halo['bound_ms'] / halo['ms']:.0%} of the bound), plain "
          f"{halo['plain_ms']:.3f} ms, the whole image's launches at the same calls "
          f"{halo['whole_ms']:.3f} ms")
    phase("i8 axis", f"phase 32 took {time.perf_counter() - t_phase:.1f} s")
    return dict(total), halo


def conv_phases(name) -> None:
    """``--convs``: the two convs' phases alone. Phases 3 and 7's checks
    (R-MG-34's shapes at batch 8 through every design), 3b's TF32 checks,
    phase 6 and 11's conv timings at batch 128 (R-MG-34's forward and
    training step, with their launches routed to window summed) and phase
    27's conv timings and TF32 checks at the saliency forward's shapes
    (3,368 images, f32)."""
    from mgtpu_torch.data.mnist import occlusion_masks

    serve, train = record_kernel_shapes(False), record_kernel_shapes(True)
    sal = record_kernel_shapes(False, SEG_RECIPES[SAL_NET][0])
    n_img = SAL_GROUP * (1 + len(occlusion_masks()))
    max_err = dict.fromkeys(KERNELS, 0.0)
    check_conv([(shape, CHECK_BATCH) for shape in serve["conv3x3"]], max_err)
    check_conv_tf32(TF32_EDGE_CASES + [(shape, CHECK_BATCH) for shape in sal["conv3x3"]],
                    "edges and the saliency shapes, batch 8: ")
    check_prologue([(shape, CHECK_BATCH) for shape in train["conv3x3_bn_relu_in"]], max_err)
    ms, plain_ms, alt = dict.fromkeys(KERNELS, 0.0), dict.fromkeys(KERNELS, 0.0), defaultdict(float)
    library_ms = {k: None if k == "conv3x3_bn_relu_in" else 0.0 for k in KERNELS}
    for k, ((h, w, ci, co), count) in enumerate(sorted(serve["conv3x3"].items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=k)
        time_conv("conv3x3", (h, w, ci, co), count, "forward", conv_fns(x, wt, b), ms, plain_ms,
                  alt, library_ms)
    for k, ((h, w, ci, co), count) in enumerate(sorted(train["conv3x3_bn_relu_in"].items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=400 + k)
        time_conv("conv3x3_bn_relu_in", (h, w, ci, co), count, "step",
                  conv_fns(x, wt, b, bn_inputs(ci, seed=400 + k)), ms, plain_ms, alt, library_ms)
    for kname, unit in (("conv3x3", "forward"), ("conv3x3_bn_relu_in", "step")):
        lib = "none" if library_ms[kname] is None else f"{library_ms[kname]:.3f} ms"
        phase("times", f"{kname} per batch-{TIME_BATCH} {unit}: kernel {ms[kname]:.3f} ms (window "
              f"{alt[('window', kname)]:.3f} ms, tile {alt[('tile', kname)]:.3f} ms), plain "
              f"{plain_ms[kname]:.3f} ms, cuDNN's one call {lib}")
        narrow_line(f"R-MG-{DEPTH}", alt, kname, f"batch-{TIME_BATCH} {unit}")
    empty = {k: Counter() for k in KERNELS}
    time_kernels(f"mnist-saliency ({SAL_NET}, {n_img} a forward)",
                 {**empty, "conv3x3": sal["conv3x3"]}, empty, n_img, 1, 1, seed=900, windows=3,
                 dtype=torch.float32)
    check_conv_tf32([(shape, n_img) for shape in sal["conv3x3"]], f"saliency at {n_img}: ")
    time_tf32(sal["conv3x3"], n_img)
    phase("convs", f"the conv phases alone on {name} took {time.perf_counter() - T0:.1f} s")


def main() -> None:
    # 1 device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke run "
          "needs an NVIDIA GPU (there is no CPU path)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    phase("device", f"{name}; {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # f32 references in full f32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2 build
    t0 = time.perf_counter()
    so, nvcc_s, log = kernels.build()
    kernels.library()
    phase("build", f"{so.name}: nvcc {nvcc_s:.1f} s, built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in log.splitlines():  # ptxas -v: each kernel's name, then its resources
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            phase("build", f"{entry}: {line.strip()}")
    if sys.argv[1:] == ["--convs"]:
        conv_phases(name)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    serve_shapes, train_shapes = record_kernel_shapes(False), record_kernel_shapes(True)
    for what, shapes, want in (("serving forward", serve_shapes, PER_FORWARD),
                               ("training step", train_shapes, PER_STEP)):
        got = {k: sum(c.values()) for k, c in shapes.items()}
        check(got == want, f"the CPU {what} made kernel calls {got}, expected {want}")
        check(sorted(shapes["maxpool2"]) == RMG34_POOLS,
              f"the CPU {what} pooled at {sorted(shapes['maxpool2'])}, expected {RMG34_POOLS}")
    conv_shapes, pool_shapes = serve_shapes["conv3x3"], serve_shapes["maxpool2"]
    max_err = dict.fromkeys(KERNELS, 0.0)
    # the designs each pass's bf16 convs take, predicted from the shapes
    serve_routes, train_routes = predicted_routes(serve_shapes), predicted_routes(train_shapes)
    check(serve_routes[("conv3x3", "sm90")] >= 70
          and train_routes[("conv3x3_bn_relu_in", "sm90")] >= 26,
          f"too few convs routed to sm90: {serve_routes}, {train_routes}")
    check(serve_routes[("maxpool2", "sm90")] == PER_FORWARD["maxpool2"]
          and train_routes[("maxpool2", "sm90")] == PER_STEP["maxpool2"],
          f"not every pool routed to sm90: {serve_routes}, {train_routes}")
    for what, routes in (("serving forward", serve_routes), ("training step", train_routes)):
        phase("route", f"per {what}, predicted: " + ", ".join(
            f"{k} {r} {n}" for (k, r), n in routes.items()))

    check_conv([(shape, CHECK_BATCH) for shape in conv_shapes], max_err)
    sal_shapes = record_kernel_shapes(False, SEG_RECIPES[SAL_NET][0])["conv3x3"]
    check_conv_tf32(TF32_EDGE_CASES + [(shape, CHECK_BATCH) for shape in sal_shapes],
                    "edges and the saliency shapes, batch 8: ")
    check_pool([(CHECK_BATCH, *shape) for shape in sorted(pool_shapes)] + POOL_EDGE_SHAPES,
               max_err)

    # 5 serve: the main path, through the entry point a user calls
    t0 = time.perf_counter()
    server = Server(RMG34, seed=0, device="cuda", compute_dtype=torch.bfloat16)
    phase("serve", f"R-MG-{DEPTH}, seeded random weights, BN folded, bf16 on {name}: "
          f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    requests = [rng.standard_normal((b, *IMAGE_SHAPE), dtype=np.float32) for b in SERVE_BATCHES]
    kernels.reset_launches()
    outs, prev = [], dict(kernels.LAUNCHES)
    for x in requests:
        prev_routes = dict(kernels.ROUTES)
        outs.append(server.predict(x))
        now = dict(kernels.LAUNCHES)
        got = {k: now[k] - prev[k] for k in now}
        check(got == PER_FORWARD, f"batch {len(x)}: kernel launches {got}, expected {PER_FORWARD}")
        check(routes_since(prev_routes) == serve_routes, f"batch {len(x)}: conv and pool "
              f"designs {routes_since(prev_routes)}, predicted {serve_routes}")
        prev = now
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    summed = {f"{k}/{r}": n // len(SERVE_BATCHES) for (k, r), n in kernels.SUMMED.items()}
    check(sum(summed.values()) > 0, f"no conv3x3 launch read a part sum: {summed}")
    for x, y in zip(requests, outs):
        lse = torch.logsumexp(y, dim=-1)
        check(y.shape == (len(x), 1000) and y.dtype == torch.float32,
              f"output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"batch {len(x)}: non-finite log-probs")
        check(bool((lse.abs() < 1e-3).all()), f"batch {len(x)}: logsumexp {lse.abs().max().item():.3g}")
    phase("serve", f"batches {list(SERVE_BATCHES)}: (B, 1000) finite f32 log-probs, rows sum to 1; "
          f"launches per forward {PER_FORWARD}, total {launches}; conv and pool designs per "
          f"forward as predicted; conv3x3 launches that read a part sum per forward {summed}")

    # the f32 forward on the card (kernels + cuDNN without TF32) against the
    # port's plain path on the CPU, same weights: f32 summation order only,
    # carried through 34 layers, bounded relative to the log-probs' scale
    x = requests[0].repeat(2, axis=0)
    x[1] = rng.standard_normal(IMAGE_SHAPE, dtype=np.float32)
    y_gpu = Server(RMG34, seed=0, device="cuda", compute_dtype=torch.float32).predict(x).cpu()
    y_cpu = Server(RMG34, seed=0, device="cpu", compute_dtype=torch.float32).predict(x)
    err = (y_gpu - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    check(err <= 1e-5 * scale, f"f32 forward: card vs CPU max abs err {err:.3g} (scale {scale:.3g})")
    y_bf16 = server.predict(x).cpu()
    phase("serve", f"f32 forward on the card vs the plain CPU forward: max abs log-prob err "
          f"{err:.3g} (bound 1e-5 x {scale:.4g}); bf16 served vs f32: max abs "
          f"{(y_bf16 - y_cpu).abs().max().item():.4g}, top-1 agree "
          f"{int((y_bf16.argmax(-1) == y_cpu.argmax(-1)).sum())}/2")

    # 6 times at batch 128, bf16
    ms = dict.fromkeys(KERNELS, 0.0)
    plain_ms = dict.fromkeys(KERNELS, 0.0)
    # the same conv launches, all through the window or the tile design,
    # and the launches routed to window (time_conv)
    alt = defaultdict(float)
    simple_ms = {"maxpool2_bwd": 0.0}  # the pool backward's launches through the simple design
    # one PyTorch call of the same function; conv3x3_bn_relu_in has none
    library_ms = {k: None if k == "conv3x3_bn_relu_in" else 0.0 for k in KERNELS}
    for k, ((h, w, ci, co), count) in enumerate(sorted(conv_shapes.items())):
        x, wt, b = conv_inputs(TIME_BATCH, h, w, ci, co, torch.bfloat16, seed=k)
        time_conv("conv3x3", (h, w, ci, co), count, "forward", conv_fns(x, wt, b), ms, plain_ms,
                  alt, library_ms)
    phase("times", f"conv3x3 per batch-{TIME_BATCH} forward: kernel {ms['conv3x3']:.3f} ms "
          f"(the window design alone {alt[('window', 'conv3x3')]:.3f} ms, the tile design alone "
          f"{alt[('tile', 'conv3x3')]:.3f} ms), plain {plain_ms['conv3x3']:.3f} ms, cuDNN's one "
          f"call {library_ms['conv3x3']:.3f} ms")
    narrow_line(f"R-MG-{DEPTH}", alt, "conv3x3", f"batch-{TIME_BATCH} forward")
    time_pool(pool_shapes, ms, plain_ms, library_ms)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (TIME_BATCH, *IMAGE_SHAPE), dtype=np.float32)).cuda()
    (t_fwd, s_fwd), = interleaved_ms([lambda: server.predict(images)], min_reps=5)
    phase("times", f"serving forward, R-MG-{DEPTH} folded bf16, batch {TIME_BATCH}: "
          f"{t_fwd:.2f} ms (spread {s_fwd:.1%}) = {TIME_BATCH / t_fwd * 1e3:.1f} img/s on {name}")
    (t_one, s_one), = interleaved_ms([lambda: server.predict(images[:1])], min_reps=5)
    phase("times", f"serving forward, batch 1: {t_one:.2f} ms per call (spread {s_one:.1%}), "
          f"back to back")
    del server, images

    check_prologue([(shape, CHECK_BATCH) for shape in train_shapes["conv3x3_bn_relu_in"]],
                   max_err)
    check_pool_bwd([tuple((CHECK_BATCH, *shape) for shape in key)
                    for key in sorted(train_shapes["maxpool2_bwd"])] + edge_groups(), max_err)
    check_grads()
    train_launches = check_train(name, train_routes)
    launches = {k: launches[k] + train_launches[k] for k in KERNELS}
    time_train(name, train_shapes, ms, plain_ms, alt, library_ms, simple_ms)

    # 12-15 the CIFAR zoo
    rec = record_cifar()
    check_cifar_kernels(rec, max_err)
    served, trained = check_cifar_serve(name, rec), check_cifar_train(name, rec)
    cifar_launches = {net: served[net] + trained[net] for net in CIFAR_RECIPES}
    launches = {k: launches[k] + sum(c[k] for c in cifar_launches.values()) for k in KERNELS}
    for k in KERNELS:  # every kernel ran on the CIFAR path (the prologue in rnmg and prnmg)
        check(sum(c[k] for c in cifar_launches.values()) > 0, f"{k} never launched on the "
              f"CIFAR path")
    c_ms, c_plain_ms, c_library_ms, c_simple_ms, c_designs = time_cifar(name, rec)

    # 16-20 the segmentation nets and PR-MG
    seg_rec, seg_extra = record_seg()
    check_seg_kernels(seg_rec, seg_extra, max_err)
    served = check_seg_serve(name, seg_rec, seg_extra)
    trained = check_seg_train(name, seg_rec)
    seg_launches = {net: served[net] + trained[net] for net in SEG_RECIPES}
    launches = {k: launches[k] + sum(c[k] for c in seg_launches.values()) for k in KERNELS}
    for k in KERNELS:  # every kernel ran on this path (the prologue in prnmg.mnist and prnmgseg)
        check(sum(c[k] for c in seg_launches.values()) > 0, f"{k} never launched on the "
              f"segmentation path")
    seg_times = time_seg(name, seg_rec)

    # 21-22 the run loop: a recipe through mgtpu_torch.main
    t0 = time.perf_counter()
    cli_launches = {"R-MG-34 recipe": check_recipe(name), "harness": check_harness_chain(name)}
    launches = {k: launches[k] + sum(c[k] for c in cli_launches.values()) for k in KERNELS}
    phase("recipe", f"phases 21-22 took {time.perf_counter() - t0:.1f} s")

    # 23-26 int8 serving
    t0 = time.perf_counter()
    i8_rec = record_i8()
    max_err["conv_i8"] = 0.0
    cases = {(key[:9], batch) for net, (_, batches) in I8_SERVE.items()
             for key in i8_rec[net]["conv_i8"] for batch in batches}
    designs = check_conv_i8(cases, max_err)
    phase("conv_i8", f"{sum(designs.values())} cases ({dict(designs)} by design) at "
          f"{len(cases)} shapes and batches (R-MG-34's int8 forward at batches 1 and 128, "
          f"cifar/prnmg's at 128, unmg's at 64; weight slices as the exchange passes them; each "
          f"through its design and, where that is not simple, the simple design; the batch-1 ones "
          f"also with x off a 16-byte boundary; {len(I8_VARIANTS)} epilogue variants each): "
          f"int32 sums and f32 and bf16 epilogues equal the plain version bit for bit (max abs "
          f"err {max_err['conv_i8']:.3g})")
    gstats = check_quant_groups(i8_rec)
    phase("quant_i8", f"the group design vs quant_i8_group_plain at {gstats['tables']} tables "
          f"({gstats['cases']} recorded groups of R-MG-34's, cifar/prnmg's and unmg's int8 "
          f"forwards at their serving batches and {len(QUANT_EDGE_GROUPS)} edge groups: odd C, "
          f"misaligned members, f32 and bf16 in one launch, MAX_MEMBERS + 1 = "
          f"{quant.MAX_MEMBERS + 1} members; static and dynamic scales): {gstats['members']} "
          f"members, {gstats['elements']} int8 values and every scale bit for bit, each member "
          f"through the per-part design too; {gstats['bad']} differ")
    (i8_served, qstats), i8_cli = check_i8_serve(name), check_i8_run_loop(name)
    i8_launches = {k: sum(c[k] for c in i8_served.values()) + i8_cli[k]
                   for k in ("conv_i8", "quant_i8")}
    check(all(i8_launches.values()) and all(c["conv3x3"] == 0 for c in i8_served.values()),
          f"int8 launches: served {i8_served}, run loop {i8_cli}")
    phase("quant_i8", f"{qstats['calls']} calls of {qstats['parts']} parts ({qstats['dynamic']} "
          f"with a dynamic scale) "
          f"of the quantizer in phase 24's int8 forwards held to quantize_act's torch ops (and "
          f"the nearest upsample) on the same activations on the card: {qstats['elements']} "
          f"int8 values, {qstats['bad_values']} differ; {qstats['bad_scales']} scales differ")
    rmg_i8 = i8_rec["ilsvrc/rnmg"]
    i8_ms = time_i8(name, rmg_i8["conv_i8"], rmg_i8["quant_i8"])
    i8_bound = i8_bounds(rmg_i8["conv_i8"], TIME_BATCH)
    i8_split_bounds = i8_bounds_by_design(rmg_i8["conv_i8"], TIME_BATCH)
    q_bytes = sum(count * quant_bytes(keys, TIME_BATCH)
                  for keys, count in rmg_i8["quant_i8"].items())
    q_bound = q_bytes / PEAK_HBM_BYTES * 1e3
    phase("bounds", f"R-MG-{DEPTH} conv_i8 per batch-{TIME_BATCH} int8 forward: "
          f"{i8_bound[0] / 1e9:.1f} GOP, {i8_bound[1] / 1e6:.1f} MB, bound {i8_bound[2]:.4f} ms "
          f"(by {i8_bound[3]}; {PEAK_INT8_OPS / 1e12:.0f} TOP/s int8, "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s); kernel {i8_ms['kernel']:.3f} ms "
          f"({i8_bound[2] / i8_ms['kernel']:.0%} of the bound; by design: " + "; ".join(
              f"{d} {i8_ms[d]:.3f} ms at {n} launches, bound {b_ms:.4f} ms by {by} "
              f"({b_ms / i8_ms[d]:.0%})" for d, (n, _, _, b_ms, by) in i8_split_bounds.items())
          + f"; the simple design at all {i8_ms['simple_all']:.3f} ms), plain "
          f"{i8_ms['plain']:.3f} ms, one PyTorch call none; "
          f"a different function (bf16 operands) at the same shapes: the conv3x3 kernel at the "
          f"3x3/s1 ones {i8_ms['conv3x3']:.3f} ms, cuDNN bf16 at all {i8_ms['cudnn']:.3f} ms")
    qpt = i8_ms["quantize_per_tensor"]
    q_parts = sum(len(keys) * n for keys, n in rmg_i8["quant_i8"].items())
    phase("bounds", f"R-MG-{DEPTH} quant_i8 per batch-{TIME_BATCH} int8 forward (static "
          f"scales, {sum(rmg_i8['quant_i8'].values())} group launches of {q_parts} parts): "
          f"{q_bytes / 1e6:.1f} MB, bound {q_bound:.4f} ms (bytes); the group design "
          f"{i8_ms['quant_i8']:.3f} ms ({q_bound / i8_ms['quant_i8']:.0%} of the bound), the "
          f"per-part design ({q_parts} launches) {i8_ms['quant_part']:.3f} ms "
          f"({q_bound / i8_ms['quant_part']:.0%}), plain torch ops "
          f"{i8_ms['quant_plain']:.3f} ms; a different function (qint8, no upsample, f32 "
          f"inputs): torch.quantize_per_tensor "
          + ("not measured" if qpt is None else f"{qpt:.3f} ms")
          + f"; host time a forward: the group wrappers {i8_ms['host_quant_i8']:.3f} ms, the "
          f"per-part wrappers {i8_ms['host_quant_part']:.3f} ms")
    i8_parts = time_i8_parts(i8_rec)
    phase("i8 times", f"phases 23-26 took {time.perf_counter() - t0:.1f} s")

    # 27 the saliency harness; 28 the train step's -remat
    sal_launches, sal_times = check_saliency(name)
    remat_launches = check_remat(name)
    # 29 data parallelism
    dp_launches = check_dp(name, smi.stdout.strip().splitlines()[0])
    launches = {k: launches[k] + sal_launches.get(k, 0) + remat_launches.get(k, 0)
                + dp_launches.get(k, 0) for k in KERNELS}
    # 30 the tools
    tool_launches = check_tools(name, smi.stdout.strip().splitlines()[0])
    launches = {k: launches[k] + tool_launches.get(k, 0) for k in KERNELS}
    # 31 the mesh's second axis
    axis_launches, halo = check_axis(name, smi.stdout.strip().splitlines()[0], train_shapes)
    launches = {k: launches[k] + axis_launches.get(k, 0) for k in KERNELS}
    i8_launches = {k: i8_launches[k] + tool_launches.get(k, 0) for k in i8_launches}
    # 32 int8 serving across ranks
    i8_axis_launches, i8_halo = check_i8_axis(name, smi.stdout.strip().splitlines()[0],
                                              rmg_i8["conv_i8"])
    launches = {k: launches[k] + i8_axis_launches.get(k, 0) for k in KERNELS}
    i8_launches = {k: i8_launches[k] + i8_axis_launches.get(k, 0) for k in i8_launches}

    # each kernel's bound over the pass its times sum: the serving forward
    # (conv3x3, maxpool2) or the training step (the other two)
    fwd_bounds = path_bounds(serve_shapes, TIME_BATCH)
    step_bounds = path_bounds(train_shapes, TIME_BATCH)
    bounds = {k: (fwd_bounds if PER_FORWARD[k] else step_bounds)[k] for k in KERNELS}
    micro, iters = CIFAR_RECIPES[CIFAR_TIMED][1:]
    # net -> (its launches, units, ms, plain ms, library ms, the pool
    # backward's simple-design ms, the convs' design times, bounds)
    designs = {k: design_times(alt, k) for k in ("conv3x3", "conv3x3_bn_relu_in")}
    nets = {f"R-MG-{DEPTH}": (None, (f"batch-{TIME_BATCH} forward", f"batch-{TIME_BATCH} step"),
                              ms, plain_ms, library_ms, simple_ms, designs, bounds),
            CIFAR_TIMED: (cifar_launches[CIFAR_TIMED], (f"batch-{CIFAR_SERVE_BATCH} forward",
                                                        f"{micro} x {iters} step"),
                          c_ms, c_plain_ms, c_library_ms, c_simple_ms, c_designs,
                          cifar_bounds(rec))}
    for net, (n_ms, n_plain, n_lib, n_simple, n_designs, n_bounds) in seg_times.items():
        _, micro, iters, batches = SEG_RECIPES[net]
        nets[net] = (seg_launches[net], (f"batch-{batches[-1]} forward", f"{micro} x {iters} step"),
                     n_ms, n_plain, n_lib, n_simple, n_designs, n_bounds)
    nets[sal_times[0]] = (sal_launches, *sal_times[1:])
    for net, (_, units, kms, kplain, klib, ksimple, kdesigns, bds) in nets.items():
        for k in kms:
            flops, nbytes, t_bound, by = bds[k]
            lib = "none" if klib[k] is None else f"{klib[k]:.3f} ms"
            other = (f" (group design; the simple design {ksimple[k]:.3f} ms)"
                     if k == "maxpool2_bwd" else
                     f" (window {kdesigns[k]['window_ms']:.3f} ms, tile "
                     f"{kdesigns[k]['tile_ms']:.3f} ms)" if k in kdesigns else "")
            phase("bounds", f"{net} {k} per {units[0] if PER_FORWARD[k] else units[1]}: "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB, bound {t_bound:.4f} ms (by "
                  f"{by}); kernel {kms[k]:.3f} ms{other} ({t_bound / kms[k]:.0%} of the bound), "
                  f"plain {kplain[k]:.3f} ms, library {lib}")
    phase("seconds", "by phase (the time up to each line, summed by its tag): " + ", ".join(
        f"{k} {v:.1f}" for k, v in SECONDS.items()) + f"; total {time.perf_counter() - T0:.1f}")
    # the top-level numbers are R-MG-34's; under each other net's name the
    # same keys for its path, for the kernels it launches; launches count
    # every main-path run
    print(json.dumps({"kernels": [
        {"name": k, **KERNELS[k], "launches": launches[k], "max_abs_err": max_err[k],
         "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bounds[k][2],
         "bound_by": bounds[k][3], "library_ms": library_ms[k],
         **({"simple_ms": simple_ms[k]} if k in simple_ms else {}),
         **({"halo_mode": {key: halo[k][key] for key in (
             "launches", "ms", "plain_ms", "whole_ms", "library_ms", "max_abs_err", "bound_ms",
             "bound_by")}}
            if k in halo else {}),
         **({"designs": {r: n for (kk, r), n in (serve_routes if PER_FORWARD[k]
                                                  else train_routes).items() if kk == k and n},
             **designs[k]} if k in designs else {}),
         **{net: {"launches": n_launches[k], "ms": kms[k], "plain_ms": kplain[k],
                  "bound_ms": bds[k][2], "bound_by": bds[k][3], "library_ms": klib[k],
                  **({"simple_ms": ksimple[k]} if k in ksimple else {}),
                  **(kdesigns[k] if k in kdesigns else {})}
            for net, (n_launches, _, kms, kplain, klib, ksimple, kdesigns, bds) in nets.items()
            if n_launches is not None and k in kms}} for k in KERNELS]
        + [{"name": "conv_i8", **KERNELS_I8["conv_i8"], "launches": i8_launches["conv_i8"],
            "max_abs_err": max_err["conv_i8"], "ms": i8_ms["kernel"], "plain_ms": i8_ms["plain"],
            "bound_ms": i8_bound[2], "bound_by": i8_bound[3], "library_ms": None,
            "designs": {d: {"launches_per_forward": n, "ms": i8_ms[d], "bound_ms": b_ms,
                            "bound_by": by}
                        for d, (n, _, _, b_ms, by) in i8_split_bounds.items()},
            "simple_design_at_all_ms": i8_ms["simple_all"], "bf16_conv3x3_ms": i8_ms["conv3x3"],
            "bf16_cudnn_ms": i8_ms["cudnn"], "stem_and_1x1_parts": i8_parts,
            "halo_mode": {key: i8_halo[key] for key in (
                "launches", "ms", "plain_ms", "whole_ms", "max_abs_err", "bound_ms",
                "bound_by")}},
           {"name": "quant_i8", **KERNELS_I8["quant_i8"], "launches": i8_launches["quant_i8"],
            "max_abs_err": float(qstats["max_abs_err"]), "ms": i8_ms["quant_i8"],
            "plain_ms": i8_ms["quant_plain"], "bound_ms": q_bound, "bound_by": "bytes",
            "library_ms": None, "quantize_per_tensor_ms": qpt,
            "designs": {"group": {"launches_per_forward": I8_PER_FORWARD["ilsvrc/rnmg"][
                                      "quant_i8"], "ms": i8_ms["quant_i8"],
                                  "host_ms": i8_ms["host_quant_i8"]},
                        "part": {"launches_per_forward": q_parts, "ms": i8_ms["quant_part"],
                                 "host_ms": i8_ms["host_quant_part"]}}}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
