#!/usr/bin/env python3
"""Smoke run of odtk_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from ``odtk_tpu_torch/csrc`` (one nvcc per
source, in parallel), drives the port's main paths through its CLI
(``odtk_tpu_torch.main``) on ResNet50FPN at its published widths (80
classes, FPN 256; 9 anchors axis-aligned, 27 rotated with a box head of
6 x 27; random weights from a seed, synthetic COCO JPEGs from
``tests/synth.py``, resize 800 / max 1333, bf16): train, infer, and
export with infer on the engines, axis-aligned and rotated; then the
same for ResNet34C4, MobileNetV2FPN and ResNet50FPN + MobileNetV2FPN
in one model; a ResNet50FPN run's files (``.ckpt`` checkpoints,
backbone weights, TensorBoard scalars, a trace, metrics); the JAX
CLI's inert layout switches (``--fused-stem / --no-fused-stem``,
``--wpack-layer1``); training and inference in a data-parallel
process group (NCCL, world 1: the machine has one card); and the
deployment extras: ``.cppengine`` packages run from Python and from the
C++ samples, and the video frame loop. It holds each
kernel against its plain PyTorch version at the shapes those paths give
it, and prints each phase's wall seconds:

  1. card: the device name and power limit;
  2. stem: the primal BN + ReLU + max-pool kernel vs plain at
     [2, 64, 448, 576] (the inference batch) and [2, 64, 448, 704] (the
     engines' batch), bf16 and fp32, bit-equal, also with NaN planted
     (and +-inf where the scale is 0): NaNs in the same places;
  3. stem-train: at [8, 64, 448, 576] (the train batch), bf16 and fp32,
     the forward with argmax bit-equal to the primal kernel and to plain,
     its idx equal to max_pool2d's indices mapped to codes, and the
     routing backward equal to the plain version's autograd; the same on
     the NaN-planted case (code 9 wherever the output is NaN);
  4. train: ``odtk-tpu-torch train`` for 20 steps at batch 8 (lr 0.001,
     warmup 10), from a seeded random init; the losses finite, each
     training kernel launched the expected number of times (the loss's
     forward and backward once a step for all five levels);
  5. loss: the loss's forward kernel, and forward + backward as
     ``Model.loss_fn`` runs them (``torch.autograd.grad`` of its loss to
     the heads), vs plain on the real heads and targets of the first
     train step's five levels: sums within a relative 1e-4, gradients
     elementwise within one bf16 ulp of the plain version's autograd in
     float64, plus 1e-12 / fg; both timed;
  6. focal-sum: the focal sum's forward and backward kernels (on no path
     of the port: the model's loss is phase 5's kernel) vs the plain
     version on the same five levels, bf16 and fp32: sums within a
     relative 1e-6, dx elementwise against the plain version's autograd
     in float64, within one bf16 ulp (bf16) or a relative 1e-5 (fp32),
     plus 1e-10;
  7. infer: ``odtk-tpu-torch infer`` on the checkpoint the train phase
     wrote (batch 2); NMS and the primal stem launched, detections
     non-empty and finite;
  8. nms: the NMS kernel (rank, suppression bitmask, scan) vs plain on
     the real [2, 2000] candidates of the infer run's first batch, on a
     synthetic [2, 5000] case with planted overlaps, ties and an IoU
     exactly at the threshold, and on those candidates with a NaN score
     planted in image 0 (which then records nothing): equal; the mask's
     same-class pairs beside the kept count;
  9. reference: fp32 inference on the card (TF32 off) vs the CPU;
 10. train-reference: one fp32 SGD step of ResNet50FPN on the card (TF32
     off) vs the same step on the CPU, at 2 x 256 x 256;
 11. export: ``odtk-tpu-torch export`` of the trained checkpoint at 800 x
     1333 (896 x 1408 after rounding to the stride) as bf16 (batch
     profiles 1 and 2), fp32, and INT8 calibrated on the JPEGs with
     absmax and with entropy; ``odtk-tpu-torch infer`` on each engine:
     the NMS and stem kernels launched once per batch inside the engine,
     detections non-empty and finite, each int8 package under the fp32
     one / 2.5, the bf16 engine equal to the checkpoint path on the
     same batches (scores within 1e-3, the same top-1 class and box),
     the stem and NMS kernels equal to plain on the tensors the bf16 and
     fp32 engines give them ([2, 64, 448, 704] conv1 outputs, the first
     batch's candidates), and each int8 engine near the bf16 one (its
     top-10 scores, and the bf16 score of its top-1 class, within
     2.5e-3 of the bf16 scores);
 12. rotated-train: ``odtk-tpu-torch train --rotated-bbox`` for 20 steps
     at batch 8 on rotated JPEGs with up to 24 boxes each, gradients
     clipped to a global norm of 25; the losses
     finite; per step the matcher launched once for all five levels, the
     loss's forward and backward kernels (at D = 6) and the stem's argmax
     forward and backward once;
 13. rotated-match: the matcher kernel's one launch for the five levels
     vs the plain stream on the real anchors and packed targets of the
     first rotated step (equal wherever the plain best IoU is > 0, <= 0
     elsewhere, the assignment's depth equal), timed; the pairs it clips
     beside the pairs whose boxes overlap; and its unbatched variant vs
     plain on one image of P3 and on degenerate cases (zero-area and NaN
     quads, touching boxes, invalid rows before and between valid ones,
     m = 33 and 200, 2920 anchors): equal bit for bit;
 14. rotated-loss: phase 5 at D = 6 on the first rotated step's heads;
 15. rotated-infer: ``odtk-tpu-torch infer`` on the rotated checkpoint
     (batch 2); the rotated NMS launched once per batch, detections
     non-empty, finite, with a ``segmentation`` polygon;
 16. rotated-nms: the rotated NMS kernel (rank, suppression bitmask,
     scan) vs plain on the real [2, 2000] candidates of that run's first
     batch, on a synthetic [2, 5000] case with tied scores, identical
     boxes, shared corners and a pair next to the threshold, and on the
     candidates with a NaN score planted in image 0: equal; the greedy
     rounds' clips beside the pairs the bitmask clips;
 17. rotated-train-reference: one fp32 rotated SGD step on the card vs
     the CPU at 2 x 256 x 256, with the tolerances of phase 10;
 18. rotated-export: phase 11 for the rotated checkpoint, with a 99.9
     percentile calibration as well, and the rotated NMS's counter;
 19. c4: ``odtk-tpu-torch train --backbone ResNet34C4`` for 10 steps at
     batch 8 (a step: the stem's argmax forward and backward, the loss's
     forward and backward once each, for its one level at stride 16);
     phase 5 on its first step's level; ``infer`` on the checkpoint; NMS
     on its candidates (phase 8's equality, also with a NaN score); a
     bf16 engine and ``infer`` on it (phase 11's checks);
 20. mobilenet: phase 19 for MobileNetV2FPN (five levels), with an INT8
     absmax engine held to the bf16 one (``int8_check``); no stem kernel
     is launched anywhere, and the engines hold no stem operator;
 21. mobilenet-reference: phase 10 for the MobileNetV2FPN checkpoint,
     and its 17 depthwise convolutions' weight gradients card vs CPU
     (``depthwise_gradient_phase``);
 22. multi: phase 19 for ResNet50FPN + MobileNetV2FPN in one model, 3
     steps: 10 levels, the loss's forward and backward launched twice a
     step (a launch takes up to eight levels);
 23. match-l10: the matcher on the first rotated step's five levels
     given twice (10 levels, two launches), every level bit-equal to
     phase 13's launch and under its rule against the plain stream;
 24. multi-rotated-train: ``train --rotated-bbox`` of the two-backbone
     model for 2 steps (the matcher and the loss twice a step each way);
 25. multi-rotated-loss: phase 5 at D = 6 on its first step's 10 levels
     (an eight-level and a two-level launch each way);
 26. ckpt: the training run's files (``ckpt_phase``): ``train r50.ckpt
     --backbone-weights`` (a seeded torchvision-format ResNet50 file,
     held equal to the backbone after ``load_backbone_weights``) for 12
     steps with ``--logdir``, ``--profile-dir`` and ``--post-metrics`` (a
     local ``http.server``), a resume from the ``.ckpt`` to 14 with its
     momentum (no "starting the momentum fresh" warning), ``infer`` on
     the ``.ckpt`` and on a ``.pth`` of the same weights (detections
     equal); the event file's three scalars equal the logged losses, the
     trace holds the stem and loss kernels' launches of its two steps,
     the collector got the four keys; the ``.ckpt`` and ``.pth`` write
     and read seconds and bytes with the momentum;
 27. fused-stem-flags (``fused_stem_phase``, on phase 4's checkpoint):
     ``infer`` with ``--no-fused-stem``, ``--fused-stem`` and
     ``--wpack-layer1`` each prints its one line, launches NMS and the
     primal stem kernel once a batch as the default run does, and gives
     the default's detections bit for bit;
 28. ddp (``ddp_phase``): data parallel in-process at world 1 over NCCL
     (one card): ``train()`` of phase 4's model, seed and data for 5
     steps twice without a group and once in it, the group's run equal
     bit for bit to the first where the two without are (cuDNN
     deterministic in the phase; else within their gap), the stem and
     loss kernels launched as often; ``infer`` in the group on phase 4's
     checkpoint and phase 11's bf16 engine, equal bit for bit to phases 7
     and 11; the world size, the gradient all-reduce's device time a
     step and its bytes beside the card's name and power limit;
 29. cppapi (``cppapi_phase``): the C++ deployment path. A bf16
     ``.cppengine`` of phase 4's checkpoint on the u8 contract and a
     rotated one of phase 12's on the f32 contract (``odtk-tpu-torch
     export``, batch 2 at 896 x 1408), their export seconds and bytes;
     each loaded in Python and held to phase 11's (18's) bf16 engine on
     the same batch by phase 11's rule, its top-1 among the engine's
     detections scored within 2e-3 of it (a compiled graph's bf16 logits
     can be a bf16 ulp from eager's; among several such, its class), NMS
     (rotated NMS) and the stem
     launched once a call, and their kernels equal to plain on the
     tensors the package gives them; the C++ samples built
     (``extras/cppapi/build.py``, seconds; the samples and the rotated
     package alongside the axis package's compile); ``odtk_infer`` on a
     synthetic image written as a PPM at the canvas size, its detections
     equal bit for bit to the Python-loaded package's on the same bytes,
     its counters one NMS and one stem launch an inference; its ms per
     inference beside the Python package's and the engine's;
     ``odtk_export`` printing each package's metadata;
 30. video (``video_phase``): ``extras/infer_video.py``'s frame loop on
     two streams of 720 x 1280 frames in memory, by the checkpoint route
     (bf16, b = 2) and by phase 11's engine, each batch equal to the
     direct call, NMS and the stem once a batch, frames per second; with
     OpenCV, ``infer_video.main`` on two mp4s.
 31. w8a8 (``w8a8_phase``): ``build_quant_variables(mode='w8a8')`` on
     phase 4's checkpoint with phase 11's persisted absmax table, bf16:
     on the first b=2 batch at 896 x 1408 every one of the 111 conv calls
     (the ``odtk::conv_w8a8`` kernel's outputs in the forward, captured by
     hooks) bit-equal to the plain version on its input, and again with
     NaN, +inf and -inf planted; ``inference_fn`` on four batches (the
     kernel 111 times a batch, the stem and NMS once), detections
     non-empty and finite; a bf16 engine exported from the w8a8 model on
     the same batches (the same launches, phase 11's rule against the
     model); the entropy table on one batch; phase 20's MobileNetV2FPN
     with its absmax table on one batch (109 calls, 17 depthwise,
     bit-equal, no stem); reports: the w8a8 engine's top-10 score gap to
     phase 11's bf16 engine beside phase 11's w8a16 gap, ms a batch of
     the w8a8 model and engine beside phase 11's bf16 and w8a16 engines,
     and the kernel's device time over one forward's 111 calls beside its
     bound, the plain version and bf16 cuDNN ``F.conv2d`` on the same
     shapes (the yardstick ``library_ms``).

Any failure raises, and the script exits non-zero. It needs a CUDA
device; without one it fails before printing any result. Kernel times
are medians of 20 runs timed with CUDA events. The line before the card
line holds one JSON object with every kernel's launches, error, times
and bound (rows 1, 2 and 9 with the C++ runs' launches as
``cpp_launches``); before it, the engines' and the ``.cppengine``'s ms
beside the card's name and power limit; the last line is the device
summary.
"""

import contextlib
import http.server
import json
import math
import os
import random
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
RUNS = 20
STEM_SHAPE = (2, 64, 448, 576)      # conv1 output of a 896x1152 canvas, b=2
ENGINE_STEM_SHAPE = (2, 64, 448, 704)   # the engines' 896x1408, b=2
TRAIN_STEM_SHAPE = (8, 64, 448, 576)
TRAIN_BATCH, TRAIN_STEPS, WARMUP = 8, 20, 10
ROTATED_MAX_BOXES = 24              # dense targets for the matcher
# the rotated box head starts at the prior bias on all six channels, so
# its smooth-L1 starts near 28 per foreground anchor, and from random
# weights the unclipped loss went non-finite at step 9 (NVIDIA H100 80GB
# HBM3, 700 W); 25 is the clip odtk-tpu train's help gives for rotated
# fine-tunes
ROTATED_CLIP_GRADS = 25.0
# from random weights (the port fetches no pretrained backbone) the
# unnormalized ResNet50 diverges within 20 steps at lr 0.01 on the card
TRAIN_LR = 0.001
HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM device memory, bytes / ms
FP32_FLOPS_PER_MS = 67e12 / 1e3      # H100 SXM fp32 outside tensor cores
# fp32 operations of one quad clip (csrc/quad_iou.cuh) at the least an
# overlapping pair needs: the pad (8 compares), both areas (32), per clip
# edge its line (5), the side of 4 vertices (16), 4 crossing tests and two
# crossings (4 + 30), then the shoelace of 4 vertices (12) and the IoU (4)
CLIP_OPS = 8 + 32 + 4 * (5 + 16 + 4 + 30) + 12 + 4


def _median_ms(fn, runs=RUNS, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_abs(a, b):
    return max((x.float() - y.float()).abs().max().item() if x.numel()
               else 0.0 for x, y in zip(a, b))


def _hold_to_float64(got, ref, rtol, atol, what, x=None, big=1e-6):
    """Holds a kernel's gradient ``got`` elementwise to ``ref``, autograd
    of the plain version in float64 (rounded to bf16 first where ``got``
    is bf16): |got - ref| <= rtol |ref| + atol. Where the logit ``x`` is
    exactly 0, autograd of the plain form takes the subgradients of its
    clamp and abs (d ce/dx = 1 - t, not the derivative s - t = 0.5 - t
    that the kernels and the JAX custom VJPs compute): those elements are
    left out. Returns the largest error, the atol the rtol would need and
    the largest relative error where |ref| > big."""
    if got.dtype == torch.bfloat16:
        ref = ref.to(torch.bfloat16).double()
    diff = (got.double() - ref).abs()
    if x is not None:
        diff = torch.where(x == 0, 0.0, diff)
    excess = diff - rtol * ref.abs()
    bad = excess > atol
    if bad.any():
        i = int(excess.argmax())
        raise AssertionError(
            f'{what} off the float64 gradient at {int(bad.sum())} of '
            f'{bad.numel()} elements: worst kernel '
            f'{got.flatten()[i].item()!r} reference '
            f'{ref.flatten()[i].item()!r}'
            + (f' x {x.flatten()[i].item()!r}' if x is not None else ''))
    large = ref.abs() > big
    rel = ((diff[large] / ref.abs()[large]).max().item() if large.any()
           else 0.0)
    return diff.max().item(), excess.max().item(), rel


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory
    rate and the fp32 operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = flops / FP32_FLOPS_PER_MS
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def card():
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _stem_inputs(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    scale = (torch.rand(shape[1], generator=g) + 0.5).to(device)
    shift = torch.randn(shape[1], generator=g).to(device)
    y = torch.randn(shape, generator=g).to(device, dtype)
    return y, scale, shift


def _stem_bytes(shape, itemsize):
    b, c, hc, wc = shape
    return b * c * hc * wc * itemsize, b * c * ((hc - 1) // 2 + 1) * (
        (wc - 1) // 2 + 1)


def _with_nan(y, scale, shift, seed):
    """Copies of a stem case with NaN planted in y (1%, a corner
    included) and +-inf in the last channel, whose scale is set to 0
    (inf * 0 = NaN)."""
    g = torch.Generator().manual_seed(seed)
    y, scale = y.clone(), scale.clone()
    nan = torch.rand(y.shape, generator=g) < 0.01
    inf = torch.rand(y[:, -1].shape, generator=g) < 0.05
    y[nan.to(y.device)] = torch.nan
    y[0, 0, 0, 0] = torch.nan
    y[:, -1][inf.to(y.device)] = torch.inf
    y[:, -1, :3, :3] = -torch.inf
    scale[-1] = 0.0
    return y, scale, shift


def _equal_nan(a, b):
    """Equal values (torch.equal's rule) with NaNs in the same places."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (a.isnan() & b.isnan())).all()))


def stem_phase(device):
    """Row 2 at the checkpoint path's and the engines' conv1 shapes, bf16
    and fp32: bit-equal to plain, NaNs in the same places on the
    NaN-planted case, timed. Returns {(dtype, shape): row}."""
    from odtk_tpu_torch.ops.kernels import stem

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (STEM_SHAPE, ENGINE_STEM_SHAPE):
            y, scale, shift = _stem_inputs(shape, dtype, device, 1)
            got = stem.bn_relu_pool(y, scale, shift)
            want = stem.bn_relu_pool_plain(y, scale, shift)
            if not torch.equal(got, want):
                raise AssertionError(
                    f'stem kernel != plain in {dtype} at {list(shape)}: max '
                    f'abs diff {_max_abs([got], [want])}')
            nan_case = _with_nan(y, scale, shift, 7)
            got_nan = stem.bn_relu_pool(*nan_case)
            want_nan = stem.bn_relu_pool_plain(*nan_case)
            if not (want_nan.isnan().any() and _equal_nan(got_nan, want_nan)):
                raise AssertionError(
                    f'stem kernel != plain on the NaN case in {dtype} at '
                    f'{list(shape)}: {int(got_nan.isnan().sum())} NaN '
                    f'outputs, plain {int(want_nan.isnan().sum())}')
            del nan_case, got_nan, want_nan
            conv, pooled = _stem_bytes(shape, y.element_size())
            row = rows[dtype, shape] = dict(
                max_abs_err=_max_abs([got], [want]),
                ms=_median_ms(lambda: stem.bn_relu_pool(y, scale, shift)),
                plain_ms=_median_ms(
                    lambda: stem.bn_relu_pool_plain(y, scale, shift)),
                bound=_bound(conv + pooled * y.element_size(), 36 * pooled))
            print(f'stem {str(dtype)[6:]} {list(shape)}: bit-equal (NaN '
                  f'case too), kernel {row["ms"]:.4f} ms, plain '
                  f'{row["plain_ms"]:.4f} ms, bound {row["bound"][0]:.4f} '
                  'ms', flush=True)
    return rows


def stem_train_phase(device):
    """The forward with argmax and the routing backward at the train
    batch's conv1 shape; sentinel windows planted in the first plane."""
    from odtk_tpu_torch.ops.kernels import stem

    fwd, bwd = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        y, scale, shift = _stem_inputs(TRAIN_STEM_SHAPE, dtype, device, 2)
        y[0, 0, :6, :6] = -3.0
        out, idx = stem.bn_relu_pool_idx(y, scale, shift)
        want_out, want_idx = stem.bn_relu_pool_idx_plain(y, scale, shift)
        if not (torch.equal(out, stem.bn_relu_pool(y, scale, shift))
                and torch.equal(out, want_out)):
            raise AssertionError(f'stem argmax forward != primal/plain in '
                                 f'{dtype}')
        if not torch.equal(idx, want_idx):
            raise AssertionError(
                f'stem idx != max_pool2d indices in {dtype}: '
                f'{int((idx != want_idx).sum())} differ')
        if not (idx == stem.SENTINEL).any():
            raise AssertionError('no sentinel window was exercised')
        stem_nan_check(y, scale, shift, dtype)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
        g = g.to(device, dtype)
        dy = stem.bn_relu_pool_bwd(idx, g, scale, TRAIN_STEM_SHAPE[2:])
        yr = y.clone().requires_grad_(True)
        plain_out = stem.bn_relu_pool_plain(yr, scale, shift)
        want_dy, = torch.autograd.grad(plain_out, yr, g, retain_graph=True)
        if not torch.equal(dy, want_dy):
            raise AssertionError(
                f'stem backward != plain autograd in {dtype}: max abs diff '
                f'{_max_abs([dy], [want_dy])}')
        s = y.element_size()
        conv, pooled = _stem_bytes(TRAIN_STEM_SHAPE, s)
        fwd[dtype] = dict(
            max_abs_err=0.0,
            ms=_median_ms(lambda: stem.bn_relu_pool_idx(y, scale, shift)),
            plain_ms=_median_ms(
                lambda: stem.bn_relu_pool_idx_plain(y, scale, shift)),
            bound=_bound(conv + pooled * (s + 1), 36 * pooled))
        bwd[dtype] = dict(
            max_abs_err=_max_abs([dy], [want_dy]),
            ms=_median_ms(lambda: stem.bn_relu_pool_bwd(
                idx, g, scale, TRAIN_STEM_SHAPE[2:])),
            plain_ms=_median_ms(lambda: torch.autograd.grad(
                plain_out, yr, g, retain_graph=True)),
            bound=_bound(conv + pooled * (s + 1), 9 * conv // s))
        del yr, plain_out
        for name, row in (('forward+argmax', fwd[dtype]),
                          ('backward', bwd[dtype])):
            print(f'stem-train {name} {str(dtype)[6:]} '
                  f'{list(TRAIN_STEM_SHAPE)}: equal, kernel '
                  f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, '
                  f'bound {row["bound"][0]:.4f} ms', flush=True)
    return fwd, bwd


def stem_nan_check(y, scale, shift, dtype):
    """Rows 3 and 4 on the NaN-planted copy of a train-shape case: the
    forward with argmax equal to plain and to the primal kernel, NaNs in
    the same places, the codes equal to plain (9 wherever the output is
    NaN), the routing backward equal to the plain version's autograd."""
    from odtk_tpu_torch.ops.kernels import stem

    y, scale, shift = _with_nan(y, scale, shift, 8)
    out, idx = stem.bn_relu_pool_idx(y, scale, shift)
    want_out, want_idx = stem.bn_relu_pool_idx_plain(y, scale, shift)
    nan = want_out.isnan()
    if not (nan.any() and _equal_nan(out, want_out)
            and _equal_nan(stem.bn_relu_pool(y, scale, shift), want_out)):
        raise AssertionError(f'stem argmax forward != primal/plain on the '
                             f'NaN case in {dtype}')
    if not (torch.equal(idx, want_idx)
            and bool((idx[nan] == stem.SENTINEL).all())):
        raise AssertionError(f'stem idx != plain codes on the NaN case in '
                             f'{dtype}: {int((idx != want_idx).sum())} differ')
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    g = g.to(y.device, y.dtype)
    yr = y.clone().requires_grad_(True)
    dy, = torch.autograd.grad(stem.bn_relu_pool_train(yr, scale, shift),
                              yr, g)
    want_dy, = torch.autograd.grad(stem.bn_relu_pool_plain(yr, scale, shift),
                                   yr, g)
    if not torch.equal(dy, want_dy):
        raise AssertionError(f'stem backward != plain autograd on the NaN '
                             f'case in {dtype}')
    print(f'stem-train NaN case {str(dtype)[6:]}: {int(nan.sum())} NaN '
          'windows, code 9 there, forward, codes and backward equal to '
          'plain', flush=True)


def synthetic_nms_case(b=2, n=5000, seed=0):
    """Integer boxes in clusters (heavy overlap), scores on a 1/32 grid
    (many equal-score ties), 5 classes, a third of the scores zero, and
    in each image a same-class pair with IoU exactly 0.5."""
    rng = np.random.RandomState(seed)
    centers = rng.randint(50, 750, (b, 40, 2))
    pick = rng.randint(0, 40, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None], axis=1)
    ctr = ctr + rng.randint(-12, 13, (b, n, 2))
    wh = rng.randint(8, 90, (b, n, 2))
    boxes = np.concatenate([ctr - wh // 2, ctr + wh // 2], -1)
    scores = rng.randint(1, 33, (b, n)) / 32.0
    scores[rng.rand(b, n) < 0.33] = 0.0
    classes = rng.randint(0, 5, (b, n))
    # 20x10 vs 10x10 at the same corner: inter 100 / union 200 = 0.5
    boxes[:, 0] = [1000, 1000, 1019, 1009]
    boxes[:, 1] = [1000, 1000, 1009, 1009]
    scores[:, :2] = [1.0, 0.5]
    classes[:, :2] = 7
    return (torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(classes.astype(np.float32)))


def with_nan_score(scores, boxes, classes):
    """The candidates with a NaN score planted in image 0: the greedy
    rounds record nothing for that image."""
    scores = scores.clone()
    scores[0, scores.shape[1] // 3] = float('nan')
    return scores, boxes, classes


def _same_class_pairs(scores, classes):
    """The live (score > 0) pairs of one class: the pairs whose IoU the
    axis NMS mask step computes, summed over the images."""
    pairs = 0
    for s, c in zip(scores, classes):
        if not bool(torch.isnan(s).any()):
            counts = torch.unique(c[s > 0], return_counts=True)[1]
            pairs += int((counts * (counts - 1) // 2).sum())
    return pairs


def nms_phase(cases, timed=('decode', 'synthetic')):
    from odtk_tpu_torch.ops.kernels import nms

    rows = {}
    for name, (s, b, c) in cases.items():
        got = nms.nms(s, b, c, 0.5, 100)
        want = nms.nms_plain(s, b, c, 0.5, 100)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f'nms kernel != plain on {name}: max abs '
                                 f'diff {_max_abs(got, want)}')
        kept = int((got[0] > 0).sum())
        pairs = _same_class_pairs(s, c)
        if name not in timed:
            print(f'nms {name} {list(s.shape)}: equal, {kept} kept, '
                  f'{pairs} same-class pairs in the mask', flush=True)
            continue
        rounds = int((got[0] > 0).sum(1).max())
        bsz, n = s.shape
        rows[name] = dict(
            max_abs_err=_max_abs(got, want),
            ms=_median_ms(lambda: nms.nms(s, b, c, 0.5, 100)),
            plain_ms=_median_ms(lambda: nms.nms_plain(s, b, c, 0.5, 100)),
            # inputs read and outputs written once; each round one IoU
            # (~14 fp32 ops) of the winner against every candidate
            bound=_bound(bsz * n * 24 + bsz * 100 * 24,
                         14 * bsz * rounds * n))
        print(f'nms {name} {list(s.shape)}: equal, {kept} kept, {pairs} '
              f'same-class pairs in the mask, kernel '
              f'{rows[name]["ms"]:.4f} ms, plain '
              f'{rows[name]["plain_ms"]:.4f} ms, bound '
              f'{rows[name]["bound"][0]:.6f} ms', flush=True)
    return rows


def make_data(root, n_images, rotated=False, max_boxes=3):
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from synth import make_dataset

    img_dir, ann = make_dataset(root, n_images=n_images, size=(480, 640),
                                max_boxes=max_boxes, seed=0, rotated=rotated,
                                fmt='jpg')
    # an 80-class model: give the ground truth 80 categories so every
    # predicted class maps to a category id
    with open(ann) as f:
        data = json.load(f)
    data['categories'] = [{'id': i + 1, 'name': f'class{i}'}
                          for i in range(80)]
    with open(ann, 'w') as f:
        json.dump(data, f)
    return img_dir, ann


def train_phase(root, img_dir, ann, rotated=False,
                backbones=('ResNet50FPN',), steps=TRAIN_STEPS, label=None):
    """``odtk-tpu-torch train`` (``--rotated-bbox`` when rotated) of
    ``backbones`` (ResNet50FPN, or another model of ``other_phases``), 80
    classes, bf16, b=8, resize 800 / max 1333, ``steps`` steps from a
    seeded random init; each kernel launched ``expected_launches`` times.
    Returns the checkpoint, the launch counts of the run, the loss inputs
    of its first step (for the loss phases), the assignment inputs of its
    first step (for the rotated-match phases), the median ms per step and
    the losses."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import model as model_mod
    from odtk_tpu_torch.ops import assign
    from odtk_tpu_torch.ops.kernels import loss, match_rotated, stem

    kind = 'rotated' if rotated else 'axis'
    label = label or ('rotated-train' if rotated else 'train')
    ckpt = os.path.join(root, f'retinanet_{"_".join(backbones)}_{kind}_'
                              'trained.pth')
    seen, snaps = [], []

    def capture(cls_heads, box_heads, cls_ts, box_ts, depths, classes,
                **kwargs):
        if not seen:       # the first step's levels, one list each
            seen.extend([t.detach().clone() for t in level] + [classes]
                        for level in zip(cls_heads, box_heads, cls_ts, box_ts,
                                         depths))
        return loss.detection_loss_sums_levels(
            cls_heads, box_heads, cls_ts, box_ts, depths, classes, **kwargs)

    def capture_snap(*args):
        if not snaps:      # the first step's targets and levels
            snaps.extend(a.clone() if torch.is_tensor(a) else a
                         for a in args)
        return assign.snap_to_anchors_rotated_levels(*args)

    # the names loss_fn calls
    model_mod.detection_loss_sums_levels = capture
    model_mod.snap_to_anchors_rotated_levels = capture_snap
    counted = {'det_loss': loss.detection_loss_fwd_kernel,
               'det_loss_bwd': loss.detection_loss_bwd_kernel,
               'stem_idx': stem.bn_relu_pool_idx,
               'stem_bwd': stem.bn_relu_pool_bwd,
               'stem_primal': stem.bn_relu_pool,
               'match_rotated': match_rotated.rotated_match_levels,
               'rotated_best_match': match_rotated.rotated_best_match}
    random.seed(0)                            # the fresh model's init seed
    for k in counted.values():
        k.launches = 0
    try:
        result = cli.main([
            'train', ckpt, '--images', img_dir, '--annotations', ann,
            '--backbone', *backbones, '--classes', '80',
            '--batch', str(TRAIN_BATCH), '--resize', '800',
            '--max-size', '1333', '--jitter', '800', '800',
            '--iters', str(steps), '--warmup', str(WARMUP),
            '--milestones', str(steps), '--lr', str(TRAIN_LR)]
            + (['--rotated-bbox', '--clip-grads', str(ROTATED_CLIP_GRADS)]
               if rotated else []))
    finally:
        model_mod.detection_loss_sums_levels = loss.detection_loss_sums_levels
        model_mod.snap_to_anchors_rotated_levels = \
            assign.snap_to_anchors_rotated_levels
    launches = {name: k.launches for name, k in counted.items()}
    expect = expected_launches(backbones, rotated, steps)
    if launches != expect:
        raise AssertionError(f'{label} launches {launches}, expected '
                             f'{expect}')
    losses = result['losses']
    if len(losses) != steps or not all(
            math.isfinite(c) and math.isfinite(b) for _, c, b in losses):
        raise AssertionError(f'{label} losses not finite: {losses}')
    ms = statistics.median(result['step_ms'][min(3, steps - 1):])
    print(f'{label}: {" + ".join(backbones)}, {len(seen)} levels, {steps} '
          f'steps, b={TRAIN_BATCH} bf16, launches {launches}, {ms:.3f} '
          f'ms/step (median after {min(3, steps - 1)}), loss first '
          f'{losses[0]} last {losses[-1]}', flush=True)
    return ckpt, launches, seen, snaps, ms, losses


CKPT_STEPS, CKPT_RESUME_STEPS = 12, 14     # the trace window: 10, 11


class _Collector(http.server.BaseHTTPRequestHandler):
    """A local metrics endpoint: records each POST's form fields."""
    posts = []

    def do_POST(self):       # noqa: N802 (http.server's name)
        body = self.rfile.read(int(self.headers['Content-Length']))
        self.posts.append(urllib.parse.parse_qs(body.decode()))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


def _varint(data, pos):
    value, shift = 0, 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if byte < 0x80:
            return value, pos


def _fields(data):
    """{field number: [values]} of a protobuf message: varints as ints,
    fixed64 / fixed32 as bytes, length-delimited as bytes."""
    out, pos = {}, 0
    while pos < len(data):
        key, pos = _varint(data, pos)
        wire = key & 7
        if wire == 0:
            value, pos = _varint(data, pos)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = data[pos:pos + n], pos + n
        elif wire == 2:
            n, pos = _varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        else:
            raise AssertionError(f'event file: wire type {wire}')
        out.setdefault(key >> 3, []).append(value)
    return out


def read_scalars(log_dir):
    """[(tag, step, value)] of the one TensorBoard event file in
    ``log_dir``, its TFRecord framing checked (the lengths; the CRCs are
    held to tensorboard's in tests/test_torch_train_flags.py), its first
    event the file version."""
    (name,) = [f for f in os.listdir(log_dir)
               if f.startswith('events.out.tfevents.')]
    with open(os.path.join(log_dir, name), 'rb') as f:
        data = f.read()
    pos, scalars, first = 0, [], True
    while pos < len(data):
        (length,) = struct.unpack('<Q', data[pos:pos + 8])
        event = _fields(data[pos + 12:pos + 12 + length])
        pos += 16 + length
        if first:
            if event.get(3) != [b'brain.Event:2']:
                raise AssertionError(f'event file version {event.get(3)}')
            first = False
            continue
        step = event.get(2, [0])[0]
        for value in _fields(event[5][0])[1]:
            value = _fields(value)
            scalars.append((value[1][0].decode(), step,
                            struct.unpack('<f', value[2][0])[0]))
    return scalars


def _trace_kernels(path, names):
    """{name: device kernel events of the Chrome trace whose name holds
    it}."""
    with open(path) as f:
        trace = json.load(f)
    kernels = [e['name'] for e in trace['traceEvents']
               if e.get('cat') == 'kernel']
    return {n: sum(n in k for k in kernels) for n in names}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _detections(path):
    with open(path) as f:
        return json.load(f)['annotations']


def ckpt_phase(root, img_dir, ann, device, smi):
    """The training run's files through the CLI, ResNet50FPN at full
    width (train phase's data, batch, sizes, bf16 and lr): ``train
    r50.ckpt --backbone-weights`` (a seeded torchvision-format ResNet50
    file) for CKPT_STEPS iterations with ``--logdir``, ``--profile-dir``
    and ``--post-metrics`` (a local ``http.server`` thread); a resume from
    the ``.ckpt`` to CKPT_RESUME_STEPS; ``infer`` on the ``.ckpt`` and on
    a ``.pth`` of the same weights. Checks the backbone equal to the file
    after ``load_backbone_weights``, the ``.ckpt``'s iteration and
    finite momentum, a resume without a fresh momentum, the three scalars
    at the logged iteration with the printed losses, the stem and loss
    kernels in the trace with the traced steps' launches, the four POSTed
    keys, the two checkpoints' detections equal. Times the ``.ckpt`` and
    ``.pth`` writes and reads of the model with its momentum. Returns the
    launch counts of its train and infer runs."""
    import warnings

    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import train as train_mod
    from odtk_tpu_torch.io import checkpoint, msgpack, opt_state
    from odtk_tpu_torch.io.torch_import import load_backbone_weights
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops.kernels import loss, stem

    wall = time.perf_counter()
    name = 'ResNet50FPN'
    # torchvision's ResNet50 layout: the port's features (kaiming convs,
    # batch norms drawn near identity), its fc head, a num_batches_tracked
    # a batch norm
    gen = torch.Generator().manual_seed(1)
    donor = Model(name, classes=80).initialize(gen)
    sd = {}
    for k, v in donor.module.backbones[name].features.state_dict().items():
        if k.endswith(('running_mean', 'bias')) and v.ndim == 1:
            v = 0.05 * torch.randn(v.shape, generator=gen)
        elif k.endswith(('running_var', 'weight')) and v.ndim == 1:
            v = 1 + 0.05 * torch.rand(v.shape, generator=gen)
        sd[k] = v
        if k.endswith('running_var'):
            sd[k[:-len('running_var')] + 'num_batches_tracked'] = \
                torch.tensor(1000)
    sd['fc.weight'] = 0.01 * torch.randn(1000, 2048, generator=gen)
    sd['fc.bias'] = torch.zeros(1000)
    weights = os.path.join(root, 'resnet50_torchvision.pth')
    torch.save(sd, weights)
    probe = Model(name, classes=80).initialize(0)
    load_backbone_weights(probe, name, weights)
    own = probe.module.state_dict()
    prefix = f'backbones.{name}.features.'
    for k, v in sd.items():
        if not k.startswith('fc.') and not k.endswith('batches_tracked') \
                and not torch.equal(own[prefix + k], v):
            raise AssertionError(f'ckpt: {prefix + k} is not the file\'s')
    del probe, own, donor

    ckpt = os.path.join(root, 'r50.ckpt')
    logdir, profile_dir = (os.path.join(root, d) for d in ('logs', 'trace'))
    _Collector.posts = []
    server = http.server.HTTPServer(('127.0.0.1', 0), _Collector)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    train_args = [
        'train', ckpt, '--images', img_dir, '--annotations', ann,
        '--backbone', name, '--classes', '80', '--batch', str(TRAIN_BATCH),
        '--resize', '800', '--max-size', '1333', '--jitter', '800', '800',
        '--warmup', str(WARMUP), '--milestones', str(CKPT_RESUME_STEPS),
        '--lr', str(TRAIN_LR)]
    counted = {'det_loss': loss.detection_loss_fwd_kernel,
               'det_loss_bwd': loss.detection_loss_bwd_kernel,
               'stem_idx': stem.bn_relu_pool_idx,
               'stem_bwd': stem.bn_relu_pool_bwd,
               'stem_primal': stem.bn_relu_pool}
    launches = dict.fromkeys(counted, 0)
    runs = []
    try:
        for steps, extra in (
                (CKPT_STEPS, ['--backbone-weights', weights, '--logdir',
                              logdir, '--profile-dir', profile_dir,
                              '--post-metrics',
                              f'http://127.0.0.1:{server.server_address[1]}/']),
                (CKPT_RESUME_STEPS, [])):
            for k in counted.values():
                k.launches = 0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                runs.append(cli.main(train_args + ['--iters', str(steps)]
                                     + extra))
            for n, k in counted.items():
                launches[n] += k.launches
            fresh = [str(w.message) for w in caught
                     if 'momentum fresh' in str(w.message)]
            if fresh:
                raise AssertionError(f'ckpt: {fresh}')
            if steps == CKPT_STEPS:
                checked = checkpoint.read(ckpt)
                if checked['iteration'] != CKPT_STEPS:
                    raise AssertionError(f'ckpt: iteration '
                                         f'{checked["iteration"]}')
                trace = msgpack.msgpack_restore(
                    checked['optimizer'])['1']['trace']   # clip 0's chain
                leaves = list(_leaves(trace))
                if not all(np.isfinite(v).all() for v in leaves) or not any(
                        np.abs(v).max() > 0 for v in leaves):
                    raise AssertionError('ckpt: momentum not finite or zero')
                del checked, trace, leaves
    finally:
        server.shutdown()
        server.server_close()
    expect = {k: v for k, v in expected_launches(   # 12 steps, then 2
        (name,), False, CKPT_RESUME_STEPS).items() if k in counted}
    if launches != expect:
        raise AssertionError(f'ckpt: launches {launches}, expected {expect}')
    first, resumed = runs
    if [it for it, _, _ in resumed['losses']] != list(
            range(CKPT_STEPS, CKPT_RESUME_STEPS)):
        raise AssertionError(f'ckpt: resumed at {resumed["losses"]}')
    if checkpoint.peek_iteration(ckpt) != CKPT_RESUME_STEPS:
        raise AssertionError('ckpt: resume did not end at '
                             f'{CKPT_RESUME_STEPS}')

    focal = float(np.mean([c for _, c, _ in first['losses']]))
    box = float(np.mean([b for _, _, b in first['losses']]))
    lr = train_mod.lr_schedule(TRAIN_LR, WARMUP, [CKPT_RESUME_STEPS],
                               0.1)(CKPT_STEPS)
    scalars = read_scalars(logdir)
    want = [('focal_loss', CKPT_STEPS, focal), ('box_loss', CKPT_STEPS, box),
            ('learning_rate', CKPT_STEPS, lr)]
    if [(t, s) for t, s, _ in scalars] != [(t, s) for t, s, _ in want] or \
            not all(math.isclose(v, w, rel_tol=1e-6)
                    for (_, _, v), (_, _, w) in zip(scalars, want)):
        raise AssertionError(f'ckpt: event file {scalars}, logged {want}')
    posted = [p['metric'][0] for p in _Collector.posts]
    if posted != ['focal loss', 'box loss', 'im_s', 'lr'] or len(
            {p['time'][0] for p in _Collector.posts}) != 1:
        raise AssertionError(f'ckpt: posted {_Collector.posts}')
    traced = CKPT_STEPS - 10
    per_step = expected_launches((name,), False, 1)
    kernel_names = {'stem_pool_fwd_kernel': per_step['stem_idx'],
                    'stem_pool_bwd_kernel': per_step['stem_bwd'],
                    'det_loss_fwd_kernel': per_step['det_loss'],
                    'det_loss_bwd_kernel': per_step['det_loss_bwd']}
    in_trace = _trace_kernels(first['trace'], kernel_names)
    if in_trace != {k: traced * n for k, n in kernel_names.items()}:
        raise AssertionError(f'ckpt: trace {first["trace"]} holds '
                             f'{in_trace}, expected {traced} steps of '
                             f'{kernel_names}')

    # the same model and momentum written and read in both formats
    model, state = Model.load(ckpt)
    model.to(device)
    optimizer = train_mod.make_optimizer(model.module.parameters(),
                                         TRAIN_LR)
    count = opt_state.restore(optimizer, model.module, state.pop('optimizer'),
                              0.0)
    io_s, sizes = {}, {}
    for ext in ('.ckpt', '.pth'):
        path = os.path.join(root, f'r50_copy{ext}')
        torch.cuda.synchronize()
        start = time.perf_counter()
        saved = (optimizer.state_dict() if ext == '.pth' else
                 opt_state.to_optax(optimizer, model.module, 0.0, count))
        model.save(dict(state, path=path, optimizer=saved))
        io_s[f'write{ext}'] = time.perf_counter() - start
        del saved
        start = time.perf_counter()
        checkpoint.read(path)
        io_s[f'read{ext}'] = time.perf_counter() - start
        sizes[ext] = os.path.getsize(path)
    del model, optimizer, state

    infer_launches, dets = {}, {}
    for ext, path in (('ckpt', ckpt), ('pth', os.path.join(
            root, 'r50_copy.pth'))):
        label = f'ckpt-infer-{ext}'
        got, _, _ = e2e_phase(root, path, img_dir, ann, label=label)
        for n, v in got.items():
            infer_launches[n] = infer_launches.get(n, 0) + v
        dets[ext] = _detections(os.path.join(
            root, f'detections_axis_{label}.json'))
    a, b = dets['ckpt'], dets['pth']
    if len(a) != len(b) or [(d['image_id'], d['category_id']) for d in a] \
            != [(d['image_id'], d['category_id']) for d in b]:
        raise AssertionError(f'ckpt: {len(a)} detections from the .ckpt, '
                             f'{len(b)} from the .pth')
    diff = max((abs(x - y) for d, e in zip(a, b)
                for x, y in zip(d['bbox'] + [d['score']],
                                e['bbox'] + [e['score']])), default=0.0)
    if diff > 1e-3:
        raise AssertionError(f'ckpt: detections differ by {diff}')
    print(f'ckpt ({smi}): count {count}; .ckpt {sizes[".ckpt"]} bytes, '
          f'write {io_s["write.ckpt"]:.3f} s, read {io_s["read.ckpt"]:.3f} '
          f's; .pth {sizes[".pth"]} bytes, write {io_s["write.pth"]:.3f} s, '
          f'read {io_s["read.pth"]:.3f} s; trace {in_trace} over {traced} '
          f'steps; scalars {scalars}; {len(a)} detections, .ckpt vs .pth '
          f'largest difference {diff}; {time.perf_counter() - wall:.1f} s '
          'wall', flush=True)
    return {'train': launches, 'infer': infer_launches}


def fused_stem_phase(root, ckpt, img_dir, ann):
    """The CLI's inert layout switches, ``--fused-stem / --no-fused-stem``
    and ``--wpack-layer1``, on ``infer`` of the train phase's ResNet50FPN
    checkpoint (batch 2), each run with the counts set to 0 just before
    it and read just after: each prints its one line, launches NMS (row
    1) and the primal stem kernel (row 2) once a batch as the default
    run does, and gives the default's detections bit for bit. Returns the
    launches of rows 1 and 2 over the phase."""
    import contextlib
    import io

    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch.ops.kernels import nms, stem

    counted = {'nms': nms.nms, 'stem': stem.bn_relu_pool}
    total = dict.fromkeys(counted, 0)
    dets = {}
    for flag in (None, '--no-fused-stem', '--fused-stem', '--wpack-layer1'):
        label = f'infer {flag or ""}'.strip()
        det = os.path.join(root, f'detections_{label.replace(" ", "")}.json')
        for k in counted.values():
            k.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = cli.main(['infer', ckpt, '--images', img_dir,
                               '--annotations', ann, '--batch', '2',
                               '--threshold', '0.001', '--output', det]
                              + ([flag] if flag else []))
        got = {n: k.launches for n, k in counted.items()}
        batches = len(result['batch_ms'])
        if got != dict.fromkeys(counted, batches):
            raise AssertionError(f'fused-stem-flags {label}: launches {got} '
                                 f'in {batches} batches')
        for n, v in got.items():
            total[n] += v
        said = [line for line in out.getvalue().splitlines()
                if ' ignored: ' in line and line.startswith('--')]
        want = [flag.replace('--no-', '--')] if flag else []
        if [line.split()[0] for line in said] != want:
            raise AssertionError(f'fused-stem-flags {label}: printed {said}')
        dets[label] = _detections(det)
        print(f'fused-stem-flags {label}: launches {got}, {said}', flush=True)
    base = dets['infer']
    for label, got in dets.items():
        if got != base:
            raise AssertionError(f'fused-stem-flags {label}: {len(got)} '
                                 f'detections differ from the default\'s '
                                 f'{len(base)}')
    print(f'fused-stem-flags: {len(base)} detections in each run, equal to '
          f'the default\'s bit for bit; launches over the phase {total}',
          flush=True)
    return total


DDP_STEPS = 5


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms, and PyTorch's where an op has
    one, for the phase's train runs; restored after."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _ddp_train(root, img_dir, ann, device, label, counted, profile=False):
    """``train()`` of ResNet50FPN at the train phase's seed, data, batch,
    sizes, augmentation and lr for DDP_STEPS steps, the loader on one
    thread (its augmentation draws then come in one order). Returns the
    losses, the parameters after the last step (on the host), the
    launches of ``counted``, and with ``profile`` the profile and the
    last step's gradients (else None, None)."""
    import functools

    from odtk_tpu_torch import train as train_mod
    from odtk_tpu_torch.data import DataIterator
    from odtk_tpu_torch.model import Model

    random.seed(0)                            # the train phase's init seed
    model = Model('ResNet50FPN', classes=80)
    model.initialize(random.randint(0, 2 ** 31 - 1))
    for k in counted.values():
        k.launches = 0
    train_mod.DataIterator = functools.partial(DataIterator, num_threads=1)
    prof, grads = None, None
    try:
        with contextlib.ExitStack() as stack:
            if profile:
                prof = stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]))
            result = train_mod.train(
                model, {'path': os.path.join(root, f'ddp_{label}.pth')},
                img_dir, ann, img_dir, None, 800, 1333, [800, 800],
                TRAIN_BATCH, DDP_STEPS, 0, TRAIN_LR, WARMUP, [DDP_STEPS],
                0.1, mixed_precision=True, verbose=False,
                augment_brightness=0.002, augment_contrast=0.002,
                augment_hue=0.0002, augment_saturation=0.002, device=device)
            torch.cuda.synchronize(device)
    finally:
        train_mod.DataIterator = DataIterator
    params = {k: v.detach().cpu() for k, v in
              model.module.state_dict().items()}
    if profile:
        grads = [p.grad for p in model.module.parameters()
                 if p.grad is not None]
    return (result['losses'], params,
            {n: k.launches for n, k in counted.items()}, prof, grads)


def _largest_gap(a, b):
    """The largest |a - b| over the losses and over the parameters."""
    loss_gap = max(abs(x - y) for p, q in zip(a[0], b[0])
                   for x, y in zip(p[1:], q[1:]))
    param_gap = max((x - y).abs().max().item()
                    for x, y in zip(a[1].values(), b[1].values()))
    return loss_gap, param_gap


def ddp_phase(root, img_dir, ann, ckpt, device, smi):
    """Data parallel on the card, in-process at world 1 over NCCL
    (``parallel.init_distributed``; a one-card machine has no world 2).
    Train: DDP_STEPS steps of ``train()`` twice without a group (A, B),
    then once in the group (C, profiled): where A and B are equal bit
    for bit (cuDNN deterministic inside the phase), C must equal A bit
    for bit, losses and parameters; else C must be within A and B's
    largest gap, printed beside it. The stem's and the loss's kernels
    launch as often in C as in A. Infer: ``infer`` in the group on the
    train phase's checkpoint and on the export phase's bf16 engine, each
    equal bit for bit to that phase's detections, NMS and the stem
    launched once a batch. Prints the world size, the gradient
    all-reduce's device time a step (NCCL's kernels in C's trace) and
    its bytes, and one all-reduce of C's gradients timed with CUDA
    events. Returns the launches of rows 1-5 over the phase."""
    import torch.distributed as dist

    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import parallel
    from odtk_tpu_torch.ops.kernels import loss, nms, stem

    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from torch_ranks import free_port

    counted = {'det_loss': loss.detection_loss_fwd_kernel,
               'det_loss_bwd': loss.detection_loss_bwd_kernel,
               'stem_idx': stem.bn_relu_pool_idx,
               'stem_bwd': stem.bn_relu_pool_bwd}
    total = dict.fromkeys([*counted, 'nms', 'stem'], 0)
    with _deterministic():
        runs = [_ddp_train(root, img_dir, ann, device, label, counted)
                for label in ('a', 'b')]
    bitwise = runs[0][0] == runs[1][0] and all(
        torch.equal(x, y) for x, y in zip(runs[0][1].values(),
                                          runs[1][1].values()))
    spread = _largest_gap(runs[0], runs[1])

    rank, world = parallel.init_distributed(f'127.0.0.1:{free_port()}', 1,
                                            0, device='cuda')
    try:
        if (dist.get_backend(), parallel.world_info()) != ('nccl', (0, 1)):
            raise AssertionError(f'ddp: group {dist.get_backend()} '
                                 f'{parallel.world_info()}')
        with _deterministic():
            runs.append(_ddp_train(root, img_dir, ann, device, 'c', counted,
                                   profile=True))
        losses, _, launches, prof, grads = runs[2]
        gap = _largest_gap(runs[0], runs[2])
        if bitwise and gap != (0.0, 0.0):
            raise AssertionError(f'ddp: the run in the group is off the run '
                                 f'without by {gap} (losses, parameters); '
                                 'two runs without are bit-equal')
        if not bitwise and (gap[0] > spread[0] or gap[1] > spread[1]):
            raise AssertionError(f'ddp: the run in the group is off the run '
                                 f'without by {gap}, beyond the spread of two '
                                 f'runs without {spread}')
        if launches != runs[0][2]:
            raise AssertionError(f'ddp: launches {launches} in the group, '
                                 f'{runs[0][2]} without')
        for run in runs:
            for n, v in run[2].items():
                total[n] += v
        nccl = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and 'nccl' in e.name.lower()]
        nccl_ms = sum(e.time_range.elapsed_us() for e in nccl) / 1e3
        # the ranges hold the flatten, the collective and the copy back:
        # a step's gradients and its fg counts (in the loss)
        (reduce_row,) = [
            e for e in prof.key_averages() if e.key == 'all_reduce_sum'
            and e.device_type == torch.autograd.DeviceType.CPU]
        range_ms = reduce_row.device_time_total / 1e3 / DDP_STEPS
        # the step's one all-reduce: the gradients and the two losses
        grads.append(torch.zeros(2, device=device))
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        reduce_ms = _median_ms(lambda: parallel.all_reduce_sum(grads))
        del grads, runs[2:]

        infer_launches = {}
        for label, path, want, flags in (
                ('ckpt', ckpt, 'detections_axis_e2e.json',
                 ['--threshold', '0.001']),
                ('engine', os.path.join(root, 'axis_export_bf16.engine'),
                 'detections_axis_export_bf16.json', [])):
            det = os.path.join(root, f'detections_ddp_{label}.json')
            for k in (nms.nms, stem.bn_relu_pool):
                k.launches = 0
            result = cli.main(['infer', path, '--images', img_dir,
                               '--annotations', ann, '--batch', '2',
                               '--output', det] + flags)
            got = {'nms': nms.nms.launches,
                   'stem': stem.bn_relu_pool.launches}
            batches = len(result['batch_ms'])
            if got != {'nms': batches, 'stem': batches}:
                raise AssertionError(f'ddp infer {label}: launches {got} '
                                     f'over {batches} batches')
            if _detections(det) != _detections(os.path.join(root, want)):
                raise AssertionError(f'ddp infer {label}: detections differ '
                                     f'from {want}')
            for n, v in got.items():
                total[n] += v
            infer_launches[label] = (got, len(_detections(det)))
    finally:
        dist.destroy_process_group()
    print(f'ddp ({smi}): world {world} over NCCL, rank {rank}; {DDP_STEPS} '
          f'steps x 3 (two without a group, one in it): runs without '
          f'bit-equal {bitwise}, their largest gap (losses, parameters) '
          f'{spread}, the group run\'s gap to the first {gap}; loss first '
          f'{losses[0]} last '
          f'{losses[-1]}; train launches a run {launches}; gradient '
          f'all-reduce {grad_bytes} bytes a step, NCCL device time '
          f'{nccl_ms / DDP_STEPS:.4f} ms a step ({len(nccl)} kernels in '
          f'{DDP_STEPS} steps), device time of the all_reduce_sum ranges '
          f'(flatten, collective, copy back; the gradients and the fg '
          f'counts, {reduce_row.count} calls) {range_ms:.4f} ms a step, one '
          f'all_reduce_sum of the gradients {reduce_ms:.4f} ms (CUDA events, '
          f'median of {RUNS}); infer '
          f'(launches, detections) {infer_launches}, equal to the e2e and '
          f'export phases\' bit for bit; launches over the phase {total}',
          flush=True)
    return total


# levels and ResNet stems (the stem kernels' users) of each backbone the
# smoke trains: a C4 net has one level, an FPN five; MobileNetV2FPN's
# stem is a plain ConvBNReLU6
BACKBONE_LEVELS = {'ResNet50FPN': 5, 'ResNet34C4': 1, 'MobileNetV2FPN': 5}
BACKBONE_STEMS = {'ResNet50FPN': 1, 'ResNet34C4': 1, 'MobileNetV2FPN': 0}


def expected_launches(backbones, rotated, steps):
    """Each training kernel's launches over ``steps`` steps: the loss's
    forward and backward (and, rotated, the matcher) once a step for
    every group of levels a launch takes (``_build.level_groups`` at
    each kernel's ``MAX_LEVELS``); the stem's argmax forward and routing
    backward once a step for every ResNet stem, its primal kernel never;
    the unbatched matcher never."""
    from odtk_tpu_torch.ops.kernels import _build, loss, match_rotated

    levels = sum(BACKBONE_LEVELS[b] for b in backbones)
    groups = len(_build.level_groups(levels, loss.MAX_LEVELS))
    matches = len(_build.level_groups(levels, match_rotated.MAX_LEVELS))
    stems = sum(BACKBONE_STEMS[b] for b in backbones)
    return {'det_loss': groups * steps, 'det_loss_bwd': groups * steps,
            'stem_idx': stems * steps, 'stem_bwd': stems * steps,
            'stem_primal': 0,
            'match_rotated': matches * steps if rotated else 0,
            'rotated_best_match': 0}


# row 5's gradients against autograd of the plain version in float64, as
# row 6's: within one bf16 ulp (2^-7) of the reference rounded to bf16
# (FOCAL_DX_RTOL for fp32 heads), plus LOSS_DX_ATOL times the cotangent
# 1 / fg, far below a background logit's ~2.24e-6 / fg at the -4.6 prior
LOSS_DX_ATOL = 1e-12


def _loss_fwd_launches(cls_heads, box_heads, cls_ts, box_ts, depths,
                       classes):
    """The forward kernel alone over all levels, a launch for each group
    of ``_build.level_groups``: fp32 [L, 2]."""
    from odtk_tpu_torch.ops.kernels import _build, loss

    sums = []
    for cut in _build.level_groups(len(cls_heads), loss.MAX_LEVELS):
        ops, geo = loss.kernel_operands(cls_heads[cut], box_heads[cut],
                                        cls_ts[cut], box_ts[cut],
                                        depths[cut], classes)
        sums.append(loss.detection_loss_fwd_kernel(ops, geo, classes))
    return torch.cat(sums)


def loss_phase(levels, label='loss'):
    """Row 5 on the first train step's levels (bf16 heads; five for
    ResNet50FPN, D = 4, or 6 for the rotated model; one for a C4 model,
    10 for two FPN backbones): the forward kernel alone, and forward +
    backward as ``Model.loss_fn`` runs them (``torch.autograd.grad`` of
    its loss, the level sums over the foreground count fg, to the heads),
    against the plain version a level at a time. Sums: relative 1e-4
    (fp32 sums of ~1e8 terms in two orders). Gradients: elementwise
    against the plain version's autograd in float64 (an image at a time),
    within one bf16 ulp of it rounded to bf16, plus LOSS_DX_ATOL / fg.
    Times are per step."""
    from odtk_tpu_torch.ops.kernels import _build, loss

    cls_heads, box_heads, cls_ts, box_ts, depths, classes = (
        list(t) for t in zip(*levels))
    classes = classes[0]
    fg = sum(max(int((d > 0).sum()), 1) for d in depths)
    sums = _loss_fwd_launches(cls_heads, box_heads, cls_ts, box_ts, depths,
                              classes)

    def kernel_loss(heads):
        s = loss.detection_loss_sums_levels(
            heads[0::2], heads[1::2], cls_ts, box_ts, depths, classes)
        return s[:, 0].sum() / fg + s[:, 1].sum() / fg

    def plain_loss(heads):
        c = b = 0
        for x, bx, cls_t, box_t, depth in zip(heads[0::2], heads[1::2],
                                              cls_ts, box_ts, depths):
            cs, bs = loss.detection_loss_sums_plain(x, bx, cls_t, box_t,
                                                    depth, classes)
            c, b = c + cs, b + bs
        return c / fg + b / fg

    def leaves():
        return [t.detach().requires_grad_(True)
                for pair in zip(cls_heads, box_heads) for t in pair]

    def grads(fn):
        heads = leaves()
        return torch.autograd.grad(fn(heads), heads)

    got = grads(kernel_loss)
    err = rel_err = 0.0
    atol_needed = -math.inf
    rtol = 2 ** -7 if cls_heads[0].dtype == torch.bfloat16 else FOCAL_DX_RTOL
    for i, (x, bx, cls_t, box_t, depth) in enumerate(zip(
            cls_heads, box_heads, cls_ts, box_ts, depths)):
        c_sum, b_sum = loss.detection_loss_sums_plain(x, bx, cls_t, box_t,
                                                      depth, classes)
        for mine, plain in ((sums[i, 0], c_sum), (sums[i, 1], b_sum)):
            rel = abs(mine.item() - plain.item()) / max(abs(plain.item()),
                                                        1e-30)
            if rel > 1e-4:
                raise AssertionError(f'{label} sums rel err {rel:.3g} at '
                                     f'level {i}')
        err = max(err, _max_abs([sums[i, 0], sums[i, 1]], [c_sum, b_sum]))
        # an image at a time: float64 autograd of a whole level would
        # hold tens of GB
        for j in range(x.shape[0]):
            one = slice(j, j + 1)
            x64 = x[one].detach().double().requires_grad_(True)
            bx64 = bx[one].detach().double().requires_grad_(True)
            c64, b64 = loss.detection_loss_sums_plain(
                x64, bx64, cls_t[one], box_t[one], depth[one], classes)
            refs = torch.autograd.grad((c64 + b64) / fg, (x64, bx64))
            del x64, bx64, c64, b64
            for mine, ref, logits, what in zip(
                    got[2 * i:2 * i + 2], refs, (x[one], None),
                    ('dx', 'dbx')):
                e, need, rel = _hold_to_float64(
                    mine[one], ref, rtol, LOSS_DX_ATOL / fg,
                    f'{label} {what} level {i} image {j}', logits,
                    big=1e-6 / fg)
                err, rel_err = max(err, e), max(rel_err, rel)
                atol_needed = max(atol_needed, need)
            del refs
        print(f'{label} level {list(x.shape)} {list(bx.shape)}: sums '
              f'{sums[i].tolist()} vs plain {[c_sum.item(), b_sum.item()]}, '
              'gradients within one bf16 ulp of the float64 gradient',
              flush=True)
    print(f'{label}: gradients vs float64, max abs err {err!r}, largest '
          f'relative err where |dx| > 1e-6 / fg {rel_err!r}, atol the rtol '
          f'needs {atol_needed!r} (allowed {LOSS_DX_ATOL / fg!r}), fg {fg}',
          flush=True)

    def plain_forward():
        with torch.no_grad():
            plain_loss([t for pair in zip(cls_heads, box_heads)
                        for t in pair])

    row = dict(
        max_abs_err=err,
        ms=_median_ms(lambda: _loss_fwd_launches(
            cls_heads, box_heads, cls_ts, box_ts, depths, classes)),
        plain_ms=_median_ms(plain_forward),
        ms_fwd_bwd=_median_ms(lambda: grads(kernel_loss)),
        plain_ms_fwd_bwd=_median_ms(lambda: grads(plain_loss)))
    # inputs read once: every logit, each anchor's int32 class and fp32
    # depth, and the box head and fp32 box targets of this run's
    # foreground anchors only (the rest have no box term or gradient);
    # outputs written once: the sums, and with the backward dx and dbx in
    # full. ~25 fp32 operations a logit forward and ~33 more for its
    # gradient; ~12 and ~4 a foreground box channel
    s = cls_heads[0].element_size()
    logits = sum(x.numel() for x in cls_heads)
    boxes = sum(bx.numel() for bx in box_heads)
    fg_boxes = sum(int((d > 0).sum()) * bt.shape[-1]
                   for d, bt in zip(depths, box_ts))
    read = logits * s + sum(d.numel() for d in depths) * 8 + fg_boxes * (
        s + 4)
    row['bound'] = _bound(read + 8 * len(levels), 25 * logits + 12 * fg_boxes)
    row.update(levels=len(levels), logits=logits)
    row['bound_fwd_bwd'] = _bound(read + 8 * len(levels)
                                  + (logits + boxes) * s,
                                  58 * logits + 16 * fg_boxes)
    launches = len(_build.level_groups(len(levels), loss.MAX_LEVELS))
    print(f'{label}: {len(levels)} levels, {logits} logits, {launches} '
          f'launch(es) each way, forward kernel {row["ms"]:.4f} ms '
          f'(plain {row["plain_ms"]:.4f}, bound {row["bound"][0]:.4f}); '
          f'forward + backward {row["ms_fwd_bwd"]:.4f} ms (plain '
          f'{row["plain_ms_fwd_bwd"]:.4f}, bound '
          f'{row["bound_fwd_bwd"][0]:.4f}) per step', flush=True)
    return row


def e2e_phase(root, ckpt, img_dir, ann, rotated=False, stems=1,
              label=None):
    """The ``infer`` CLI on the synthetic set with the trained checkpoint
    (a rotated model by the checkpoint's angles): NMS launched once a
    batch, the primal stem ``stems`` times a batch (0 for
    MobileNetV2FPN). Returns the launch counts of the run, the NMS inputs
    of its first batch (for the NMS phases) and its median ms per batch
    after the first."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import model as model_mod
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    kind = 'rotated' if rotated else 'axis'
    label = label or ('rotated-infer' if rotated else 'e2e')
    det = os.path.join(root, f'detections_{kind}_{label}.json')
    fn = nms_rotated.nms_rotated if rotated else nms.nms
    name = 'nms_rotated' if rotated else 'nms'
    seen = []

    def capture(scores, boxes, classes, *args):
        if not seen:
            seen.extend((scores, boxes, classes))
        return fn(scores, boxes, classes, *args)

    setattr(model_mod, name, capture)   # the name Model.inference_fn calls
    counted = {'nms': nms.nms, 'nms_rotated': nms_rotated.nms_rotated,
               'stem': stem.bn_relu_pool}
    for k in counted.values():
        k.launches = 0
    try:
        result = cli.main(['infer', ckpt, '--images', img_dir,
                           '--annotations', ann, '--batch', '2',
                           '--threshold', '0.001', '--output', det])
    finally:
        setattr(model_mod, name, fn)
    launches = {n: k.launches for n, k in counted.items()}
    batches = len(result['batch_ms'])
    other = 'nms' if rotated else 'nms_rotated'
    if (launches[name] != batches or launches['stem'] != stems * batches
            or launches[other] != 0):
        raise AssertionError(f'{label} launches {launches} over '
                             f'{batches} batches')
    with open(det) as f:
        dets = json.load(f)['annotations']
    if not dets:
        raise AssertionError(f'{label}: no detections')
    for d in dets:
        values = d['bbox'] + [d['score']]
        if rotated:
            if len(d['bbox']) != 5 or len(d['segmentation'][0]) != 8:
                raise AssertionError(f'not a rotated detection: {d}')
            values += d['segmentation'][0]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f'non-finite detection {d}')
    ms = statistics.median(result['batch_ms'][1:])
    print(f'{label}: {len(dets)} detections, launches {launches}, '
          f'{ms:.3f} ms/batch (b=2, bf16)', flush=True)
    return launches, seen, ms


def reference_phase(ckpt, device):
    """fp32 on the card (TF32 off) vs the same model on the CPU, on two
    256x256 images: heads within 1e-4 of their scale, the decoded
    candidate scores (sorted, so near-ties cannot reorder them) within
    1e-5."""
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops import eval_normalize_u8

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (2, 256, 256, 3),
                                          np.uint8))
    sizes = torch.tensor([[256.0, 256.0], [200.0, 240.0]])
    out = {}
    for dev in ('cpu', device):
        model, _ = Model.load(ckpt, device=dev)
        model.threshold = 0.001
        x = eval_normalize_u8(images.to(dev), sizes.to(dev))
        cls_heads, box_heads = model.forward_heads(x)
        out[dev] = ([h.cpu() for h in cls_heads + box_heads],
                    model.candidates(x)[0].cpu())
    err = max(((a - b).abs().max() / a.abs().max()).item()
              for a, b in zip(out['cpu'][0], out[device][0]))
    score_err = (out['cpu'][1] - out[device][1]).abs().max().item()
    if err > 1e-4 or score_err > 1e-5:
        raise AssertionError(f'card vs CPU: heads rel err {err:.3g}, '
                             f'candidate scores err {score_err:.3g}')
    print(f'reference: fp32 card vs CPU heads rel err {err:.3g}, candidate '
          f'scores max err {score_err:.3g}', flush=True)


def reference_errors(ckpt, devices, rotated=False):
    """One fp32 SGD step (lr 0.01, momentum 0.9, weight decay 1e-4) of
    the checkpoint's model on each of the two ``devices`` (TF32 off), on
    the same two 256x256 u8 images and targets (rotated targets (x, y,
    w, h, theta, class) for a rotated model). Returns the relative error
    of the second against the first: of the losses, and of the update
    the step applies, lr x the momentum buffer (the first step's buffer
    is the gradient plus the weight decay), before it is rounded into
    the parameter's fp32 ulp, in L2 over all parameters, for the median
    tensor and for the worst tensor."""
    from odtk_tpu_torch import train
    from odtk_tpu_torch.model import Model

    lr = 0.01
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = []
    for dev in devices:
        model, _ = Model.load(ckpt, device=dev)
        params = dict(model.module.named_parameters())
        opt = train.make_optimizer(params.values(), lr)
        step = train.make_train_step(model, opt, feed='u8')
        cl, bl = step(lr, *(t.to(dev) for t in reference_batch(rotated)))
        result.append(((cl.item(), bl.item()),
                       {k: lr * opt.state[p]['momentum_buffer'].double().cpu()
                        for k, p in params.items()}))
    ((c0, b0), u0), ((c1, b1), u1) = result
    per = {k: ((u1[k] - u0[k]).norm() / u0[k].norm().clamp(min=1e-30))
           .item() for k in u0}
    worst = max(per, key=per.get)
    return dict(
        loss=max(abs(c1 - c0) / abs(c0), abs(b1 - b0) / abs(b0)),
        total=(sum(((u1[k] - u0[k]) ** 2).sum() for k in u0)
               / sum((u0[k] ** 2).sum() for k in u0)).sqrt().item(),
        median=statistics.median(per.values()), worst=worst,
        worst_err=per[worst])


def reference_batch(rotated=False):
    """The reference phases' u8 batch: (images [2, 256, 256, 3] u8,
    targets [2, 8, 5] (x, y, w, h, class), or [2, 8, 6] with theta for a
    rotated model, colours [2, 3, 4], valid sizes [2, 2])."""
    rng = np.random.RandomState(5)
    u8 = torch.from_numpy(rng.randint(0, 256, (2, 256, 256, 3), np.uint8))
    colors = torch.zeros(2, 3, 4)
    colors[:, :, :3] = torch.eye(3) / (255 * 0.226)
    colors[:, :, 3] = -0.45 / 0.226
    sizes = torch.tensor([[256.0, 256.0], [200.0, 240.0]])
    targets = torch.full((2, 8, 5), -1.0)
    targets[0, :3] = torch.tensor([[20, 30, 60, 80, 1], [100, 40, 90, 50, 7],
                                   [150, 150, 64, 64, 3]], dtype=torch.float)
    targets[1, :2] = torch.tensor([[10, 10, 120, 100, 0],
                                   [130, 60, 40, 90, 42]], dtype=torch.float)
    if rotated:
        theta = torch.tensor([[0.3, -0.5, 0.1], [0.7, -0.2, 0.0]])
        targets = torch.cat([targets[..., :4], torch.zeros(2, 8, 1),
                             targets[..., 4:]], -1)
        targets[0, :3, 4] = theta[0]
        targets[1, :2, 4] = theta[1, :2]
    return u8, targets, colors, sizes


def train_reference_phase(ckpt, device, rotated=False, name=None):
    """``reference_errors`` of the card against the CPU from the trained
    checkpoint. Losses within a relative 1e-4; the update in relative L2
    within 5e-3 over all parameters and for the median tensor (fp32
    convolutions summed in other orders through the network and its
    backward) and 5e-2 for every tensor. A ReLU or max-pool decision on
    a value near 0 can go either way between the two sums, and one such
    flip in layer4 (2 x 8 x 8 positions per channel at 256x256) moves a
    weight's gradient by ~1/128 of it; a max-pool flip in the stem
    moves conv1's, whose gradient weighs most in the whole update. How
    many flips a step meets depends on the weights
    (``reference_spread.py`` measures the spread over seeded inits). A
    gradient path that is wrong or missing moves its tensors by order
    1."""
    name = name or ('rotated-train-reference' if rotated
                    else 'train-reference')
    e = reference_errors(ckpt, ('cpu', device), rotated)
    print(f'{name}: fp32 step card vs CPU, losses rel err {e["loss"]:.3g}; '
          f'parameter update rel L2 err over all {e["total"]:.3g}, median '
          f'tensor {e["median"]:.3g}, largest {e["worst_err"]:.3g} '
          f'({e["worst"]})', flush=True)
    if (e['loss'] > 1e-4 or e['total'] > 5e-3 or e['median'] > 5e-3
            or e['worst_err'] > 5e-2):
        raise AssertionError(f'{name} card vs CPU out of bounds: {e}')


def depthwise_gradient_phase(ckpt, device):
    """The gradients of MobileNetV2FPN's 17 depthwise convolution weights
    (PyTorch's grouped kernels on the card) from one fp32 loss on the
    reference batch, card (TF32 off) vs CPU: relative L2 per tensor, the
    median within 5e-3 and every tensor within 5e-2, phase 10's update
    bounds. Phase 10's update of a MobileNetV2FPN from random weights is
    mostly its weight decay (behind heads drawn at std 0.01 its backbone
    gradients are far below 1e-4 x the weights), so it says little about
    these convolutions; their gradients, each scaled by its own norm, do."""
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops import apply_color_affine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    u8, targets, colors, sizes = reference_batch()
    grads = []
    for dev in ('cpu', device):
        model, _ = Model.load(ckpt, device=dev)
        names = [n for n, m in model.module.named_modules()
                 if isinstance(m, torch.nn.Conv2d) and m.groups > 1]
        weights = [model.module.get_submodule(n).weight for n in names]
        images = apply_color_affine(u8.to(dev), colors.to(dev),
                                    sizes.to(dev))
        cl, bl = model.loss_fn(images, targets.to(dev))
        grads.append([g.double().cpu() for g in torch.autograd.grad(
            cl + bl, weights)])
    per = {n: ((b - a).norm() / a.norm().clamp(min=1e-300)).item()
           for n, a, b in zip(names, *grads)}
    worst = max(per, key=per.get)
    median = statistics.median(per.values())
    norms = [g.norm().item() for g in grads[0]]
    print(f'mobilenet-reference: {len(per)} depthwise weight gradients, card '
          f'vs CPU rel L2 median {median:.3g}, largest {per[worst]:.3g} '
          f'({worst}); gradient norms {min(norms):.3g}-{max(norms):.3g}',
          flush=True)
    if len(per) != 17 or median > 5e-3 or per[worst] > 5e-2:
        raise AssertionError(f'mobilenet-reference depthwise gradients out '
                             f'of bounds: {per}')


def _bits_equal(got, want):
    """(IoU, index) pairs equal, the IoUs bit for bit."""
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))


def _aabb_pairs(subj, rows, n_act):
    """(anchor, active target) pairs whose AABBs overlap: the pairs the
    matcher must clip, summed over the images."""
    q = subj.reshape(-1, 4, 2)
    lo, hi = q.amin(1), q.amax(1)                            # [N, 2]
    pairs = 0
    for b in range(rows.shape[0]):
        t = rows[b, :int(n_act[b]), :8].reshape(-1, 4, 2)
        tlo, thi = t.amin(1), t.amax(1)                       # [M, 2]
        pairs += int(((lo[:, None] <= thi[None]) & (hi[:, None] >= tlo[None]))
                     .all(-1).sum())
    return pairs


def _tile_pairs(subj, rows, n_act, tile=256):
    """The pairs a tile skip clips (the matcher's earlier design): every
    live anchor of a tile of 256 consecutive anchors against each active
    target whose AABB meets the tile's AABB, summed over the images."""
    q = subj.reshape(-1, 4, 2)
    n = q.shape[0]
    pad = -n % tile
    lo = torch.cat([q.amin(1), q.new_full((pad, 2), math.inf)])
    hi = torch.cat([q.amax(1), q.new_full((pad, 2), -math.inf)])
    tlo, thi = lo.view(-1, tile, 2).amin(1), hi.view(-1, tile, 2).amax(1)
    live = torch.full((tlo.shape[0],), tile, device=q.device)
    live[-1] = tile - pad
    pairs = 0
    for b in range(rows.shape[0]):
        t = rows[b, :int(n_act[b]), :8].reshape(-1, 4, 2)
        meet = ((t.amin(1)[None] <= thi[:, None])
                & (t.amax(1)[None] >= tlo[:, None])).all(-1)   # [T, M]
        pairs += int((meet.sum(1) * live).sum())
    return pairs


def rotated_match_phase(snaps):
    """The matcher kernel's one launch for the first rotated step's five
    levels vs the plain stream on the real anchors and packed targets:
    equal IoU and slot wherever the plain best IoU is > 0, <= 0 elsewhere,
    and the assignment's depth equal; timed, with the pairs it clips
    beside the pairs whose AABBs overlap. Then the unbatched variant vs
    plain on the first image of P3, with the pairs it clips beside the
    pairs whose boxes overlap and every valid pair, and on the degenerate
    cases of ``tests/rotated_cases.py`` (zero-area, NaN, infinite and
    huge quads, touching boxes, ties, invalid rows before and between the
    valid ones; m = 33 and 200; 2920 anchors): equal bit for bit."""
    from odtk_tpu_torch.ops import assign, iou_rotated
    from odtk_tpu_torch.ops.kernels import match_rotated as km

    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from rotated_cases import degenerate_case

    targets, sizes, strides, tables, classes, ious = snaps
    cls, valid, _, boxes_rot = assign.rotated_targets(targets.float())
    quads = [assign.rotated_level_anchors(size, stride, table,
                                          targets.device)[1]
             for size, stride, table in zip(sizes, strides, tables)]
    subj, rows, n_act = iou_rotated.match_inputs_levels(quads, boxes_rot,
                                                        valid, ious[0])
    args = (subj, rows, n_act)
    got = km.rotated_match_levels(*args)
    want = km.rotated_match_levels_plain(*args)
    nbytes = rows.numel() * 4 + n_act.numel() * 4
    aabb_total = clipped_total = tile_total = 0
    for level, stride in enumerate(strides):
        (g_iou, g_slot), (w_iou, w_slot) = got[level], want[level]
        hit = w_iou > 0
        if not (torch.equal(g_iou[hit], w_iou[hit])
                and torch.equal(g_slot[hit], w_slot[hit])
                and bool((g_iou[~hit] <= 0).all())):
            raise AssertionError(f'match kernel != plain at stride {stride}')
        depths = [assign._depth_and_class(
            iou, torch.gather(cls, 1, slot.long()), classes, ious)[1]
            for iou, slot in (got[level], want[level])]
        if not torch.equal(*depths):
            raise AssertionError(f'assignment depth differs at stride '
                                 f'{stride}')
        level_args = (subj[level], rows[level], n_act[level])
        aabb = _aabb_pairs(*level_args)
        clipped = int(km.clip_mask(*level_args).sum())
        tiles = _tile_pairs(*level_args)
        aabb_total += aabb
        clipped_total += clipped
        tile_total += tiles
        b, n = w_iou.shape
        nbytes += subj[level].numel() * 4 + b * n * 8
        print(f'rotated-match stride {stride} [{b}, {n}] x '
              f'{n_act[level].tolist()} targets: IoU > 0 at '
              f'{int(hit.sum())} (equal), kernel at -2 '
              f'{int((g_iou == -2).sum())} vs plain '
              f'{int((w_iou == -2).sum())}, foreground '
              f'{int((depths[0] > 0).sum())}, pairs clipped {clipped}, '
              f'AABB pairs {aabb}, tile-skip clips {tiles}', flush=True)
    k_ms = _median_ms(lambda: km.rotated_match_levels(*args))
    p_ms = _median_ms(lambda: km.rotated_match_levels_plain(*args), runs=3,
                      warmup=1)
    match_row = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                     bound=_bound(nbytes, aabb_total * CLIP_OPS),
                     pairs=aabb_total, clipped=clipped_total)
    print(f'rotated-match: 5 levels in one launch, kernel {k_ms:.4f} ms, '
          f'plain {p_ms:.4f} ms, bound {match_row["bound"][0]:.4f} ms per '
          f'step; pairs clipped {clipped_total}, AABB pairs {aabb_total}, '
          f'clipped by a tile skip {tile_total}', flush=True)

    args = (quads[0], boxes_rot[0], valid[0])
    got = km.rotated_best_match(*args)
    want = km.rotated_best_match_plain(*args)
    if not _bits_equal(got, want):
        raise AssertionError('rotated_best_match kernel != plain')
    n, m = quads[0].shape[0], boxes_rot.shape[1]
    live = boxes_rot[0][valid[0]]
    every = n * live.shape[0]
    live_rows = torch.cat([live, live.new_zeros(live.shape[0], 1)], 1)
    n_live = torch.tensor([live.shape[0]], device=live.device)
    overlap = _aabb_pairs(quads[0], live_rows[None], n_live)
    clipped = int(km.clip_mask(quads[0], live_rows[None], n_live).sum())
    best_row = dict(
        max_abs_err=0.0, ms=_median_ms(lambda: km.rotated_best_match(*args)),
        plain_ms=_median_ms(lambda: km.rotated_best_match_plain(*args),
                            runs=3, warmup=1),
        bound=_bound(n * 32 + m * 33 + n * 8, overlap * CLIP_OPS),
        pairs=overlap, clipped=clipped, every_pair=every)
    print(f'rotated_best_match [{n}] x {m} (P3, image 0, '
          f'{live.shape[0]} valid): equal bit for bit, kernel '
          f'{best_row["ms"]:.4f} ms, plain {best_row["plain_ms"]:.4f} ms, '
          f'bound {best_row["bound"][0]:.4f} ms; pairs clipped {clipped}, '
          f'pairs whose boxes overlap {overlap}, every valid pair {every}',
          flush=True)
    for m_rows, invalid in ((33, True), (200, True), (33, False)):
        d_args = [t.to(quads[0].device)
                  for t in degenerate_case(m_rows, invalid=invalid)]
        got = km.rotated_best_match(*d_args)
        if not _bits_equal(got, km.rotated_best_match_plain(*d_args)):
            raise AssertionError(f'rotated_best_match kernel != plain on '
                                 f'the degenerate case, m = {m_rows}')
        print(f'rotated_best_match degenerate [{d_args[0].shape[0]}] x '
              f'{m_rows} ({int(d_args[2].sum())} valid): equal bit for bit',
              flush=True)
    return match_row, best_row


def match_ten_phase(snaps):
    """Row 7 past one launch: the first rotated step's five levels given
    twice (the 10 levels of two FPN backbones) through
    ``rotated_match_levels``: a launch for each group of up to
    ``MAX_LEVELS``, every level bit-equal to the five-level launch's and
    under phase 13's rule against the plain stream (equal IoU and slot
    wherever the plain best IoU is > 0, <= 0 elsewhere); timed."""
    from odtk_tpu_torch.ops import assign, iou_rotated
    from odtk_tpu_torch.ops.kernels import _build
    from odtk_tpu_torch.ops.kernels import match_rotated as km

    targets, sizes, strides, tables, _, ious = snaps
    _, valid, _, boxes_rot = assign.rotated_targets(targets.float())
    quads = [assign.rotated_level_anchors(size, stride, table,
                                          targets.device)[1]
             for size, stride, table in zip(sizes, strides, tables)]
    args = iou_rotated.match_inputs_levels(quads * 2, boxes_rot, valid,
                                           ious[0])
    subj, rows, n_act = args
    five = km.rotated_match_levels(subj[:5], rows[:5], n_act[:5])
    before = km.rotated_match_levels.launches
    got = km.rotated_match_levels(*args)
    torch.cuda.synchronize()
    launches = km.rotated_match_levels.launches - before
    if launches != len(_build.level_groups(len(subj), km.MAX_LEVELS)):
        raise AssertionError(f'match-l10: {launches} launches for '
                             f'{len(subj)} levels')
    want = km.rotated_match_levels_plain(subj[:5], rows[:5], n_act[:5])
    nbytes = rows.numel() * 4 + n_act.numel() * 4
    pairs = 0
    for level, (g_iou, g_slot) in enumerate(got):
        f_iou, f_slot = five[level % 5]
        w_iou, w_slot = want[level % 5]
        hit = w_iou > 0
        if not (torch.equal(g_iou, f_iou) and torch.equal(g_slot, f_slot)):
            raise AssertionError(f'match-l10: level {level} differs from '
                                 'the five-level launch')
        if not (torch.equal(g_iou[hit], w_iou[hit])
                and torch.equal(g_slot[hit], w_slot[hit])
                and bool((g_iou[~hit] <= 0).all())):
            raise AssertionError(f'match-l10: kernel != plain at level '
                                 f'{level}')
        b, n = w_iou.shape
        nbytes += subj[level].numel() * 4 + b * n * 8
        pairs += _aabb_pairs(subj[level], rows[level], n_act[level])
    row = dict(max_abs_err=0.0,
               ms=_median_ms(lambda: km.rotated_match_levels(*args)),
               plain_ms=_median_ms(
                   lambda: km.rotated_match_levels_plain(*args), runs=3,
                   warmup=1),
               bound=_bound(nbytes, pairs * CLIP_OPS), levels=len(subj),
               pairs=pairs)
    print(f'match-l10: {len(subj)} levels in {launches} launches, each '
          'level bit-equal to the five-level launch and held to the plain '
          f'stream; kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} '
          f'ms, bound {row["bound"][0]:.4f} ms; AABB pairs {pairs}',
          flush=True)
    return row


def synthetic_rotated_nms_case(b=2, n=5000, seed=0):
    """Rotated boxes in clusters, scores on a 1/32 grid (ties), a third
    of the scores zero, 5 classes; each image also holds exact copies of
    boxes, boxes sharing corner coordinates with others, and a same-class
    axis-aligned pair whose IoU sits next to 0.5 (10x10 inside 20x10 at
    one corner: 0.5 exactly but for the +0.001 pad of the shared
    corners)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(50, 750, (b, 40, 2))
    pick = rng.randint(0, 40, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None], axis=1)
    ctr = ctr + rng.uniform(-12, 12, (b, n, 2))
    wh = rng.uniform(8, 90, (b, n, 2))
    th = rng.uniform(-np.pi / 2, np.pi / 2, (b, n))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2, np.sin(th)[..., None],
                            np.cos(th)[..., None]], -1)
    boxes[:, 2:400:2] = boxes[:, 3:401:2]                 # exact copies
    boxes[:, 400:800:2, :2] = boxes[:, 401:801:2, :2]     # shared corners
    scores = rng.randint(1, 33, (b, n)) / 32.0
    scores[rng.rand(b, n) < 0.33] = 0.0
    classes = rng.randint(0, 5, (b, n))
    boxes[:, 0] = [1000, 1000, 1020, 1010, 0, 1]
    boxes[:, 1] = [1000, 1000, 1010, 1010, 0, 1]
    scores[:, :2] = [1.0, 0.5]
    classes[:, :2] = 7
    return (torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(classes.astype(np.float32)))


def _nms_rotated_work(scores, boxes, classes, thr, ndet):
    """The rounds of the greedy NMS that record a detection, and the
    clips they need (live candidates of the winner's class), replayed."""
    from odtk_tpu_torch.ops.iou_rotated import (_corner_lists, clip_iou,
                                                sincos_box_corners)
    s = scores.clone()
    corners = sincos_box_corners(boxes)
    rows = torch.arange(s.shape[0], device=s.device)
    rounds = clips = 0
    for _ in range(ndet):
        m = s.argmax(dim=1)
        picked = s[rows, m] > 0
        if not bool(picked.any()):
            break
        mc = classes[rows, m]
        same = classes == mc[:, None]
        live = (s != 0) & same & picked[:, None]
        live[rows, m] = False
        rounds += int(picked.sum())
        clips += int(live.sum())
        cx, cy = _corner_lists(corners[rows, m], 1)
        suppress = (clip_iou(corners, cx, cy) > thr) & same
        suppress[rows, m] = True
        s = torch.where(picked[:, None] & suppress, 0.0, s)
    return rounds, clips


def _bitmask_pairs(scores, boxes, classes):
    """The pairs the bitmask design clips (csrc/nms_rotated.cu, mask
    step): live candidates (score > 0) of one class whose quads are not
    both finite with axis-aligned boxes apart by more than twice
    SKIP_MARGIN, summed over the images."""
    from odtk_tpu_torch.ops.iou_rotated import sincos_box_corners
    from odtk_tpu_torch.ops.kernels.nms_rotated import SKIP_MARGIN

    pairs = 0
    for s, b, c in zip(scores, boxes, classes):
        live = s > 0
        q = sincos_box_corners(b[live]).reshape(-1, 4, 2)
        lo, hi = q.amin(1) - SKIP_MARGIN, q.amax(1) + SKIP_MARGIN
        finite = torch.isfinite(q).flatten(1).all(1)
        apart = ((lo[None] > hi[:, None]) | (lo[:, None] > hi[None])).any(-1)
        skip = finite[:, None] & finite[None] & apart
        same = c[live][:, None] == c[live][None]
        pairs += int((same & ~skip).triu(1).sum())
    return pairs


def rotated_nms_phase(cases, timed=('decode', 'synthetic')):
    from odtk_tpu_torch.ops.iou_rotated import (quad_iou_one_vs_all,
                                                sincos_box_corners)
    from odtk_tpu_torch.ops.kernels import nms_rotated as knr

    rows = {}
    for name, (s, b, c) in cases.items():
        got = knr.nms_rotated(s, b, c, 0.5, 100)
        want = knr.nms_rotated_plain(s, b, c, 0.5, 100)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f'rotated nms kernel != plain on {name}: '
                                 f'max abs diff {_max_abs(got, want)}')
        kept = int((got[0] > 0).sum())
        if name not in timed:
            print(f'rotated-nms {name} {list(s.shape)}: equal, {kept} kept',
                  flush=True)
            continue
        rounds, clips = _nms_rotated_work(s, b, c, 0.5, 100)
        pairs = _bitmask_pairs(s, b, c)
        bsz, n = s.shape
        rows[name] = dict(
            max_abs_err=_max_abs(got, want),
            ms=_median_ms(lambda: knr.nms_rotated(s, b, c, 0.5, 100)),
            plain_ms=_median_ms(
                lambda: knr.nms_rotated_plain(s, b, c, 0.5, 100), runs=3,
                warmup=1),
            # inputs read and outputs written once; each round an argmax
            # over the candidates and one clip per live same-class one
            bound=_bound(bsz * n * 32 + bsz * 100 * 32,
                         rounds * n + clips * CLIP_OPS))
        extra = ''
        if name == 'synthetic':
            corners = sincos_box_corners(b[0, :2])
            iou = quad_iou_one_vs_all(corners[1:], corners[0]).item()
            extra = f', planted pair IoU {iou!r}'
        print(f'rotated-nms {name} {list(s.shape)}: equal, {kept} kept, '
              f'{rounds} rounds, {clips} greedy clips, {pairs} pairs '
              f'clipped by the bitmask, kernel '
              f'{rows[name]["ms"]:.4f} ms, plain '
              f'{rows[name]["plain_ms"]:.4f} ms, bound '
              f'{rows[name]["bound"][0]:.6f} ms{extra}', flush=True)
    return rows


FOCAL_G = 0.37                      # the cotangent of the focal-sum phase
# dx against autograd of the plain version in float64, elementwise: fp32
# within FOCAL_DX_RTOL of each element, bf16 within one ulp (2^-7) of the
# reference rounded to bf16, both plus FOCAL_DX_ATOL, far below the
# background anchors' |dx| (~8e-7 at the -4.6 prior). The closed form in
# fp32 computes q = 1 - p_t, as the TPU kernel does, which costs it
# relative precision only where q, and with it |dx| ~ q^3, is tiny.
FOCAL_DX_RTOL = 1e-5
FOCAL_DX_ATOL = 1e-10


def focal_phase(levels):
    """Row 6, the focal sum's forward and backward kernels, vs
    ``focal_sum_plain`` and its autograd gradient (cotangent 0.37) on the
    class heads and targets of the first train step's five levels, bf16
    (the heads as they come) and fp32 (an NHWC view of an fp32 NCHW copy).
    The sum within a relative 1e-6 of the plain one (fp32 sums of ~1e8
    terms in two orders); dx elementwise against the float64 gradient,
    within FOCAL_DX_RTOL (fp32) or one bf16 ulp (bf16), plus FOCAL_DX_ATOL.
    The autograd Function (both kernels) gives the dx kernel's gradient
    bit for bit. Times are per step, summed over the levels."""
    from odtk_tpu_torch.ops.kernels import focal

    fwd, bwd = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        f_ms = d_ms = pf_ms = pd_ms = fb = db = 0.0
        sum_err = dx_err = rel_err = 0.0
        atol_needed = -math.inf
        for cls_head, _, cls_t, _, depth, classes in levels:
            x = cls_head.detach()
            if dtype == torch.float32:
                x = x.permute(0, 3, 1, 2).float().contiguous().permute(
                    0, 2, 3, 1)
            g = torch.tensor(FOCAL_G, device=x.device)
            got = focal.focal_sum_kernel(x, cls_t, depth, classes)
            dx = focal.focal_sum_dx_kernel(x, cls_t, depth, g, classes)
            xr = x.clone().requires_grad_(True)
            want = focal.focal_sum_plain(xr, cls_t, depth, classes)
            rel = abs(got.item() - want.item()) / abs(want.item())
            if rel > 1e-6:
                raise AssertionError(f'focal sum {dtype} rel err {rel:.3g}')
            x64 = x.double().requires_grad_(True)
            ref, = torch.autograd.grad(focal.focal_sum_plain(
                x64, cls_t, depth, classes), x64, g.double())
            del x64
            rtol = FOCAL_DX_RTOL if dtype == torch.float32 else 2 ** -7
            err, need, rel = _hold_to_float64(dx, ref, rtol, FOCAL_DX_ATOL,
                                              f'focal dx {dtype}', x)
            dx_err = max(dx_err, err)
            atol_needed = max(atol_needed, need)
            rel_err = max(rel_err, rel)
            del ref
            xa = x.clone().requires_grad_(True)
            focal.focal_sum(xa, cls_t, depth, classes).backward(g)
            if not torch.equal(xa.grad, dx):
                raise AssertionError('focal autograd Function != dx kernel')
            del xa
            sum_err = max(sum_err, abs(got.item() - want.item()))
            f_ms += _median_ms(lambda: focal.focal_sum_kernel(
                x, cls_t, depth, classes))
            d_ms += _median_ms(lambda: focal.focal_sum_dx_kernel(
                x, cls_t, depth, g, classes))
            pf_ms += _median_ms(lambda: focal.focal_sum_plain(
                xr, cls_t, depth, classes))
            pd_ms += _median_ms(lambda: torch.autograd.grad(
                want, xr, g, retain_graph=True))
            s, logits, n = x.element_size(), x.numel(), depth.numel()
            # inputs read once (the head, fp32 class and depth), outputs
            # written once (the sum; dx); ~25 fp32 operations per logit in
            # the forward (sigmoid, log1p, exp, the focal product), ~33
            # with the gradient
            fb += _bound(logits * s + n * 8 + 4, 25 * logits)[0]
            db += _bound(2 * logits * s + n * 8 + 4, 33 * logits)[0]
            del xr, want
        name = str(dtype)[6:]
        fwd[dtype] = dict(max_abs_err=sum_err, ms=f_ms, plain_ms=pf_ms,
                          bound=(fb, 'bytes'))
        bwd[dtype] = dict(max_abs_err=dx_err, ms=d_ms, plain_ms=pd_ms,
                          bound=(db, 'bytes'))
        print(f'focal-sum {name}: 5 levels, sums within 1e-6, dx within '
              f'tolerance of the float64 gradient (max abs err {dx_err!r}, '
              f'largest relative err where |dx| > 1e-6 {rel_err!r}, atol '
              f'the rtol needs {atol_needed!r}); forward kernel {f_ms:.4f} ms, plain {pf_ms:.4f} ms, bound '
              f'{fb:.4f} ms; backward kernel {d_ms:.4f} ms, plain '
              f'{pd_ms:.4f} ms, bound {db:.4f} ms per step', flush=True)
    return fwd, bwd


ENGINE_SIZE = ('800', '1333')        # rounded up to 896 x 1408 (stride 128)
ENGINE_THRESHOLD = 0.001


def engine_path(root, kind, label, name):
    """Where ``export_phase`` writes an engine."""
    return os.path.join(root, f'{kind}_{label}_{name}.engine')


def export_phase(root, ckpt, img_dir, ann, device, rotated=False,
                 names=None, stems=1, label=None):
    """``odtk-tpu-torch export`` of the trained checkpoint: bf16 with batch
    profiles 1 and 2, fp32, and INT8 calibrated on the synthetic JPEGs
    with absmax and with entropy (and, rotated, a 99.9 percentile), or
    the flavours ``names`` lists, then ``odtk-tpu-torch infer`` on each engine
    (batch 2). Checks: non-empty, finite detection JSONs; the NMS
    (rotated NMS) counter rose by one per batch during each engine's run,
    the stem's by ``stems`` (0 for MobileNetV2FPN); the bf16 engine's
    detections equal the checkpoint path's on the same f32 batches at the
    engine geometry (scores within 1e-3, the same top-1 class and box to
    0.5 px per image); on the first batch, the stem and NMS kernels equal
    their plain versions on the inputs the bf16 and fp32 engines give
    them; each int8 engine near the bf16 one on every batch
    (``int8_check``); each int8 package under the fp32 one / 2.5 where
    both are exported. Returns ({engine: ms per batch}, the stem kernel's
    launches over the engines' infer runs, {int8 engine: its
    ``int8_check`` numbers' maxima})."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch.data import DataIterator, RotatedDataIterator
    from odtk_tpu_torch.export import Engine
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    kind = 'rotated' if rotated else 'axis'
    label = label or ('rotated-export' if rotated else 'export')
    nms_fn = nms_rotated.nms_rotated if rotated else nms.nms
    other = nms.nms if rotated else nms_rotated.nms_rotated
    calib = ['--int8', '--calibration-images', img_dir,
             '--calibration-batches', '4']
    flavours = {
        'bf16': ['--dynamic-batch-opts', '1', '2', '2'],
        'fp32': ['--full-precision', '--dynamic-batch-opts', '2', '2', '2'],
        'int8_absmax': calib + ['--dynamic-batch-opts', '2', '2', '2'],
        'int8_entropy': calib + ['--calibration-entropy',
                                 '--dynamic-batch-opts', '2', '2', '2'],
    }
    if rotated:
        flavours['int8_p99.9'] = calib + ['--calibration-percentile', '99.9',
                                          '--dynamic-batch-opts', '2', '2',
                                          '2']
    if names is not None:
        flavours = {name: flavours[name] for name in names}
    paths, sizes, ms = {}, {}, {}
    stem_launches = 0
    for name, flags in flavours.items():
        path = engine_path(root, kind, label, name)
        table = os.path.join(root, f'{kind}_{label}_{name}.calib.json')
        start = time.perf_counter()
        cli.main(['export', ckpt, path, '--size', *ENGINE_SIZE,
                  '--threshold', str(ENGINE_THRESHOLD),
                  '--calibration-table', table, *flags])
        export_s = time.perf_counter() - start
        paths[name], sizes[name] = path, os.path.getsize(path)

        det = os.path.join(root, f'detections_{kind}_{label}_{name}.json')
        for k in (nms_fn, other, stem.bn_relu_pool):
            k.launches = 0
        result = cli.main(['infer', path, '--images', img_dir,
                           '--annotations', ann, '--batch', '2',
                           '--output', det])
        batches = len(result['batch_ms'])
        launches = (nms_fn.launches, stem.bn_relu_pool.launches,
                    other.launches)
        if launches != (batches, stems * batches, 0):
            raise AssertionError(f'{label} {name}: launches (nms, stem, '
                                 f'other nms) {launches} over {batches} '
                                 'batches: the engine did not run the '
                                 'kernels')
        stem_launches += launches[1]
        with open(det) as f:
            dets = json.load(f)['annotations']
        if not dets:
            raise AssertionError(f'{label} {name}: no detections')
        for d in dets:
            values = d['bbox'] + [d['score']] + (
                d['segmentation'][0] if rotated else [])
            if not all(math.isfinite(v) for v in values):
                raise AssertionError(f'{label} {name}: non-finite {d}')
        ms[name] = statistics.median(result['batch_ms'][1:])
        print(f'{label} {name}: exported in {export_s:.1f} s, '
              f'{sizes[name]} bytes; infer {len(dets)} detections, '
              f'{ms[name]:.3f} ms/batch (b=2, median after the first), '
              f'kernel launches (nms, stem) {launches[:2]}', flush=True)
    for name in sizes:
        if (name.startswith('int8') and 'fp32' in sizes
                and sizes[name] >= sizes['fp32'] / 2.5):
            raise AssertionError(f'{label}: {name} package {sizes[name]} '
                                 f'bytes, not under fp32 {sizes["fp32"]} / '
                                 '2.5')

    engines = {name: Engine.load(path) for name, path in paths.items()}
    engine = engines['bf16']
    model, _ = Model.load(ckpt, device=device)
    model.set_dtype(torch.bfloat16)
    model.threshold = ENGINE_THRESHOLD
    iterator = (RotatedDataIterator if rotated else DataIterator)(
        img_dir, 800, max(engine.input_size), 2, model.stride, 1, ann,
        training=False, fixed_size=engine.input_size, emit='f32')
    score_err, compared, tied = 0.0, 0, 0
    int8_err = {name: (0.0, 0.0) for name in engines
                if name.startswith('int8')}
    for data, _, _ in iterator:
        x = torch.from_numpy(data).to(device)
        if not compared:
            for name in ('bf16', 'fp32'):
                if name in engines:
                    engine_kernels_check(f'{label} {name}', engines[name],
                                         x, rotated, stems)
        got = engine(x)
        want = model.inference_fn(x)
        for name in int8_err:
            int8_err[name] = tuple(map(max, int8_err[name], int8_check(
                f'{label} {name}', engines[name](x), got)))
        err, ties = top1_rule(label, got, want)
        score_err, tied = max(score_err, err), tied + ties
        compared += x.shape[0]
    print(f'{label}: bf16 engine vs checkpoint path on {compared} images at '
          f'{list(engine.input_size)}: scores max err {score_err!r}, top-1 '
          f'class and box equal ({tied} images with a tie at the top); '
          f'int8 engines vs bf16 (top-{INT8_TOP_K} scores max err, the '
          f'int8 top-1 class\'s gap to the bf16 top score) {int8_err}; '
          f'package bytes {sizes}', flush=True)
    return ms, stem_launches, int8_err


def top1_rule(label, got, want, what='engine', ref='checkpoint path',
              tie=0.0):
    """Phase 11's rule for one batch: ``got``'s scores within 1e-3 of
    ``want``'s, and each image's top-1 (class and box to 0.5 px) one of
    ``want``'s detections tied at its top score. With ``tie`` > 0 the
    tied detections are those scored within ``tie`` of ``got``'s top-1,
    and where there are several the top-1's class is one of theirs: among
    near-tied scores one bf16 ulp picks which box NMS keeps. Returns (the
    largest score error, the images with a tie at the top); raises
    otherwise."""
    score_err = (got[0] - want[0]).abs().max().item()
    tied = 0
    for i in range(got[0].shape[0]):
        # a model 20 steps from random weights gives many detections
        # the same bf16 score: the top-1 is any of those tied at the top
        if tie:
            top = (want[0][i] - got[0][i, 0]).abs() <= tie
        else:
            top = want[0][i] == want[0][i, 0]
        tied += int(top.sum()) > 1
        box_err = (got[1][i, 0] - want[1][i][top]).abs().amax(-1)
        ok = want[2][i][top] == got[2][i, 0]
        if not (tie and int(top.sum()) > 1):
            ok &= box_err <= 0.5
        if not bool(ok.any()):
            raise AssertionError(
                f'{label}: {what} top-1 (class {got[2][i, 0].item()}, '
                f'score {got[0][i, 0].item()!r}, box '
                f'{got[1][i, 0].tolist()}) is none of the {ref}\'s '
                f'{int(top.sum())} at its top score '
                f'{want[0][i, 0].item()!r} (box errs {box_err.tolist()})')
    if score_err > 1e-3:
        raise AssertionError(f'{label}: {what} scores off the {ref} by '
                             f'{score_err}')
    return score_err, tied


class _OperatorInputs(TorchDispatchMode):
    """Records the inputs of the first call of each ``odtk::`` operator
    made while it is active: the kernels' arguments inside an engine."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith('odtk::') and name not in self.seen:
            self.seen[name] = [a.clone() if torch.is_tensor(a) else a
                               for a in args]
        return func(*args, **(kwargs or {}))


def engine_kernels_check(label, engine, x, rotated, stems=1):
    """The stem and NMS (rotated NMS) kernels on the tensors the engine
    itself gives them on batch x (its conv1 output at the engine geometry,
    the decode candidates of its heads), each equal to its plain version;
    with ``stems`` 0 (MobileNetV2FPN), the stem operator must be absent
    from the engine's run."""
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    with _OperatorInputs() as inputs:
        engine(x)
    if not stems:
        if 'odtk::bn_relu_pool' in inputs.seen:
            raise AssertionError(f'{label}: the engine ran the stem '
                                 'operator, the model has no ResNet stem')
        stem_text = 'no stem operator'
    else:
        y, scale, shift = inputs.seen['odtk::bn_relu_pool']
        if not torch.equal(stem.bn_relu_pool(y, scale, shift),
                           stem.bn_relu_pool_plain(y, scale, shift)):
            raise AssertionError(f'{label}: stem kernel != plain on the '
                                 f'engine\'s {list(y.shape)} {y.dtype} '
                                 'input')
        stem_text = (f'the stem kernel on the engine\'s {list(y.shape)} '
                     f'{str(y.dtype)[6:]} conv1 output')
    op, fn, plain = (('odtk::nms_rotated', nms_rotated.nms_rotated,
                      nms_rotated.nms_rotated_plain) if rotated else
                     ('odtk::nms', nms.nms, nms.nms_plain))
    args = inputs.seen[op]
    got, want = fn(*args), plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f'{label}: {op} kernel != plain on the '
                             f'engine\'s candidates: max abs diff '
                             f'{_max_abs(got, want)}')
    print(f'{label}: {stem_text} and {op[6:]} on its '
          f'{list(args[1].shape)} candidates ({int((got[0] > 0).sum())} '
          'kept) equal their plain versions', flush=True)


# an int8 engine against the bf16 one on the same batch: the first
# INT8_TOP_K scores of each image within INT8_SCORE_TOL, and its top-1
# class among the bf16 detections scored within INT8_SCORE_TOL of the top.
# w8a16 engines of every calibration read 1.1e-3 (axis) and 5.4e-4
# (rotated) top-10 errors, with the top-1 class at the bf16 top score
# (NVIDIA H100 80GB HBM3, 700 W, 20-step models): the bound is ~2x that.
INT8_TOP_K = 10
INT8_SCORE_TOL = 2.5e-3


def int8_gaps(got, ref):
    """Int8 detections ``got`` against the bf16 engine's ``ref`` on one
    batch: (the largest top-k score error, the largest gap between the
    bf16 top score and the bf16 engine's best score for the int8 top-1
    class)."""
    err = (got[0][:, :INT8_TOP_K] - ref[0][:, :INT8_TOP_K]).abs().max().item()
    gap = 0.0
    for i in range(ref[0].shape[0]):
        same = ref[0][i][ref[2][i] == got[2][i, 0]]
        gap = max(gap, (ref[0][i, 0] - same.max()).item() if same.numel()
                  else math.inf)
    return err, gap


def int8_check(label, got, ref):
    """``int8_gaps``; raises where either passes INT8_SCORE_TOL."""
    err, gap = int8_gaps(got, ref)
    if not max(err, gap) <= INT8_SCORE_TOL:
        raise AssertionError(f'{label}: top-{INT8_TOP_K} scores off the bf16 '
                             f'engine\'s by {err!r}, top-1 class {gap!r} '
                             'below its top score')
    return err, gap


# the other backbones' models: (backbones, train steps, engines); C4
# has one level, MobileNetV2FPN no stem kernel, the pair 10 levels
OTHER_MODELS = {
    'c4': (('ResNet34C4',), 10, ('bf16',)),
    'mobilenet': (('MobileNetV2FPN',), 10, ('bf16', 'int8_absmax')),
    'multi': (('ResNet50FPN', 'MobileNetV2FPN'), 3, ('bf16',)),
}


CPP_ITERS = 100       # odtk_infer's timed inferences, after one warmup


def _host_ms(fn, iters=CPP_ITERS):
    """Wall ms per call of ``fn`` (which ends in a host copy) over
    ``iters`` calls after one warmup: odtk_infer's own timing."""
    fn()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - start) / iters * 1e3


def _read_ppm(path):
    with open(path, 'rb') as f:
        data = f.read()
    magic, w, h, maxval, pixels = data.split(maxsplit=4)
    if magic != b'P6' or maxval != b'255':
        raise ValueError(f'{path}: not an 8-bit P6 PPM')
    return np.frombuffer(pixels, np.uint8).reshape(int(h), int(w), 3)


def _cpp_detections(path, batch, ndet, box_dim):
    """odtk_infer's detection file as float32 (scores, boxes, classes)."""
    rows = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if rows.shape != (batch * ndet, 4 + box_dim):
        raise AssertionError(f'{path}: {rows.shape} values')
    rows = rows.astype(np.float32)
    return (rows[:, 2].reshape(batch, ndet),
            rows[:, 4:].reshape(batch, ndet * box_dim),
            rows[:, 3].reshape(batch, ndet))


def _cpp_run(cmd, label):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f'{label}: {" ".join(cmd)} exited '
                             f'{out.returncode}:\n{out.stdout[-3000:]}\n'
                             f'{out.stderr[-3000:]}')
    return out.stdout


def _cpp_launches(stdout, when):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith(f'launches {when}:'))
    return {k: int(v) for k, v in (kv.split('=')
                                   for kv in line.split(':')[1].split())}


def cppapi_phase(root, ckpt, engine_path, rot_ckpt, rot_engine_path,
                 img_dir, device, smi):
    """The C++ deployment path: a bf16 ``.cppengine`` of phase 4's
    checkpoint on the u8 contract and a rotated bf16 one of phase 12's
    on the f32 contract (``odtk-tpu-torch export``, batch 2 at 896 x
    1408, phase 11's threshold), each loaded in Python and held to its
    bf16 ``.engine`` of phases 11 and 18 on the same batch by phase 11's
    rule (the top-1 among the engine's detections scored within 2e-3 of
    it: among several, by class), the NMS (rotated NMS) and stem
    operators launched once a call
    and their kernels equal to plain on the tensors the package gives
    them; the C++ samples built (``extras/cppapi/build.py``; the samples
    in a thread and the rotated package in a second process, alongside
    the axis package's compile); on one
    synthetic image written as a PPM at the canvas size (letterbox ratio
    1), ``odtk_infer`` of each package gives the Python-loaded package's
    detections bit for bit, and its counters show one NMS and one stem
    launch an inference; ``odtk_export`` prints each package's metadata.
    Returns the counters of the C++ runs and the Python launches."""
    from PIL import Image

    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch.data.coco import IMAGENET_MEAN, IMAGENET_STD
    from odtk_tpu_torch.export import Engine, load_cpp_engine, normalize_u8
    from odtk_tpu_torch.extras.cppapi import build as cppapi_build
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    def export_args(source, path, fmt):
        return ['export', source, path, '--size', *ENGINE_SIZE,
                '--threshold', str(ENGINE_THRESHOLD),
                '--dynamic-batch-opts', '1', '2', '2', '--input-format', fmt]

    # the rotated package compiles in a process of its own and the samples
    # build in a thread, both while the axis package compiles here: each
    # compile is mostly one core's work
    paths = {kind: os.path.join(root, f'{kind}.cppengine')
             for kind in ('axis', 'rotated')}
    start = time.perf_counter()
    rotated_export = subprocess.Popen(
        [sys.executable, '-m', 'odtk_tpu_torch.main',
         *export_args(rot_ckpt, paths['rotated'], 'f32')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    built = {}

    def build_samples():
        try:
            built.update(cppapi_build.build())
        except Exception as e:      # raised again below, in this thread
            built['error'] = e
        built['seconds'] = time.perf_counter() - start

    samples = threading.Thread(target=build_samples)
    samples.start()
    cli.main(export_args(ckpt, paths['axis'], 'u8'))
    seconds = {'axis': time.perf_counter() - start}
    samples.join()
    output = rotated_export.communicate(timeout=1200)[0]
    seconds['rotated'] = time.perf_counter() - start
    if 'error' in built:
        raise built['error']
    if rotated_export.returncode != 0:
        raise AssertionError(f'cppapi rotated: export exited '
                             f'{rotated_export.returncode}:\n'
                             f'{output[-3000:]}')
    binaries = built
    print(f'cppapi: C++ samples built in {built["seconds"]:.1f} s beside the '
          f'axis export ({smi}): {binaries["configure"]}', flush=True)
    for kind in paths:
        print(f'cppapi {kind}: bf16 .cppengine exported in '
              f'{seconds[kind]:.1f} s (both started together), '
              f'{os.path.getsize(paths[kind])} bytes ({smi})', flush=True)

    # the synthetic image at the canvas size, as the package's u8 and the
    # engine's f32 batch (image 1 black, as odtk_infer pads the batch)
    height, width = (-(-int(s) // 128) * 128 for s in ENGINE_SIZE)
    first = sorted(os.listdir(img_dir))[0]
    image = Image.open(os.path.join(img_dir, first)).convert('RGB')
    ppm = os.path.join(root, 'cppapi.ppm')
    image.resize((width, height), Image.BILINEAR).save(ppm)
    pixels = _read_ppm(ppm)
    u8 = np.zeros((2, height, width, 3), np.uint8)
    u8[0] = pixels
    f32 = np.zeros(u8.shape, np.float32)
    # odtk_aoti.h's Preprocess, in its float32 order
    f32[0] = ((pixels.astype(np.float32) / np.float32(255.0)
               - IMAGENET_MEAN) / IMAGENET_STD)

    cases = (('axis', engine_path, 'u8', nms.nms, u8),
             ('rotated', rot_engine_path, 'f32', nms_rotated.nms_rotated,
              f32))
    py, cpp, ms = {}, {}, {}
    for kind, engine_file, fmt, nms_fn, batch in cases:
        label = f'cppapi {kind}'
        path = paths[kind]
        package = load_cpp_engine(path)
        meta = package.get_metadata()
        engine = Engine.load(engine_file)
        x_host = torch.from_numpy(batch)
        x = x_host.to(device)
        # the engine's f32 contract: the package's own u8 normalization
        x_f32 = normalize_u8(x) if fmt == 'u8' else x
        x_f32_host = x_f32.cpu()

        for k in (nms_fn, stem.bn_relu_pool):
            k.launches = 0
        got = package(x)
        launches = (nms_fn.launches, stem.bn_relu_pool.launches)
        if launches != (1, 1):
            raise AssertionError(f'{label}: launches (nms, stem) {launches} '
                                 'in one call of the package')
        py[kind] = launches
        box_dim = int(meta['box_dim'])
        got_3d = (got[0], got[1].reshape(2, -1, box_dim), got[2])
        # the compiled graph's bf16 logits can differ from the eager
        # engine's by a bf16 ulp, a score by up to 6.9e-4 (NVIDIA H100
        # 80GB HBM3, 700 W, the axis package of phase 4's model), and
        # dozens of that model's detections score within one of the top:
        # the top-1 is held to those within two such steps of its score
        err, tied = top1_rule(label, got_3d, engine(x_f32),
                              what='.cppengine', ref='bf16 .engine',
                              tie=2e-3)
        engine_kernels_check(label, package, x, kind == 'rotated')

        det = os.path.join(root, f'{kind}.cppengine.txt')
        out = _cpp_run([binaries['odtk_infer'], path, ppm,
                        os.path.join(root, f'{kind}.out.ppm'), det], label)
        want = [o.cpu().numpy() for o in package(x)]
        cpp_det = _cpp_detections(det, 2, int(meta['detections']), box_dim)
        for a, b, what in zip(cpp_det, want, ('scores', 'boxes', 'classes')):
            if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                raise AssertionError(
                    f'{label}: odtk_infer {what} != the Python-loaded '
                    f'package\'s: max abs diff {np.abs(a - b).max()!r}')
        one, all_ = (_cpp_launches(out, 'after 1 inference'),
                     _cpp_launches(out, f'after {CPP_ITERS + 1} inferences'))
        name = 'nms_rotated' if kind == 'rotated' else 'nms'
        other = 'nms' if kind == 'rotated' else 'nms_rotated'
        for n, counts in ((1, one), (CPP_ITERS + 1, all_)):
            if (counts[name], counts['bn_relu_pool'], counts[other]) != \
                    (n, n, 0):
                raise AssertionError(f'{label}: odtk_infer launches {counts} '
                                     f'over {n} inferences')
        cpp[kind] = all_
        cpp_ms = float(out.split('Took ')[1].split(' ms')[0])
        ms[kind] = dict(
            cpp=cpp_ms,
            python=_host_ms(lambda: [o.cpu() for o in package(
                x_host.to(device))]),
            engine=_host_ms(lambda: [o.cpu() for o in engine(x_f32_host)]))
        print(f'{label}: vs the bf16 .engine scores max err {err!r} ({tied} '
              f'images tied at the top); odtk_infer on {first} as a '
              f'{width} x {height} PPM equal bit for bit to the '
              f'Python-loaded package ({int((want[0] > 0).sum())} '
              f'detections), launches {all_} over {CPP_ITERS + 1} '
              f'inferences; ms per inference (host copies in, b=2) C++ '
              f'{ms[kind]["cpp"]}, Python package {ms[kind]["python"]}, '
              f'.engine {ms[kind]["engine"]} ({smi})', flush=True)

        printed = _cpp_run([binaries['odtk_export'], path], label)
        shown = {}
        for ln in printed.splitlines():
            if ln.startswith('meta:'):
                key, _, value = ln[len('meta:'):].strip().partition(' =')
                shown[key] = value.strip()
        if shown != dict(meta):
            raise AssertionError(f'{label}: odtk_export printed {shown}, '
                                 f'the package holds {meta}')
        print(f'{label}: odtk_export contract:\n{printed}', flush=True)
        del package, engine
    return dict(py=py, cpp=cpp, ms=ms)


VIDEO_FRAMES = 8         # frames a stream
VIDEO_HW = (720, 1280)


def video_phase(ckpt, engine_path, img_dir, root, device, smi):
    """``extras/infer_video.py``'s frame loop (``run_streams``) on two
    synthetic streams of 720 x 1280 frames in memory, by the checkpoint
    route (``inference_fn_u8`` in bf16, b = 2, the 640 canvas) and by
    phase 11's bf16 engine: each batch's detections equal the route's
    function called directly on the same batch, NMS and the stem launched
    once a batch; frames per second. With OpenCV, also ``main`` on two
    3-frame mp4s. Returns the launches {nms, stem}."""
    from PIL import Image

    from odtk_tpu_torch.export import Engine
    from odtk_tpu_torch.extras import infer_video
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops.kernels import nms, stem

    names = sorted(os.listdir(img_dir))
    streams = [[np.asarray(Image.open(os.path.join(img_dir, names[
        (s * VIDEO_FRAMES + i) % len(names)])).convert('RGB').resize(
            VIDEO_HW[::-1], Image.BILINEAR)) for i in range(VIDEO_FRAMES)]
        for s in range(2)]
    model, _ = Model.load(ckpt, device=device)
    model.set_dtype(torch.bfloat16)
    engine = Engine.load(engine_path)
    routes = {
        'checkpoint': (infer_video.checkpoint_dispatch(model, 640), True,
                       lambda b, s: model.inference_fn_u8(
                           torch.from_numpy(b), torch.from_numpy(s))),
        'engine': (infer_video.engine_dispatch(engine), False,
                   lambda b, s: engine(b)),
    }
    launches = {'nms': 0, 'stem': 0}
    for route, ((dispatch, canvas), u8_feed, direct) in routes.items():
        # warm: the engine loads its program at its first call
        [o.cpu() for o in direct(np.zeros((2, *canvas, 3), np.uint8 if u8_feed
                                          else np.float32),
                                 np.zeros((2, 2), np.float32))]
        seen = []
        for k in (nms.nms, stem.bn_relu_pool):
            k.launches = 0
        start = time.perf_counter()
        batches = infer_video.run_streams(
            dispatch, streams, canvas, u8_feed,
            on_batch=lambda *item: seen.append(item))
        wall = time.perf_counter() - start
        counts = (nms.nms.launches, stem.bn_relu_pool.launches)
        if batches != VIDEO_FRAMES or counts != (batches, batches):
            raise AssertionError(f'video {route}: {batches} batches, '
                                 f'launches (nms, stem) {counts}')
        launches['nms'] += counts[0]
        launches['stem'] += counts[1]
        for frames, ratios, batch, sizes, out in seen:
            want = [o.cpu().numpy() for o in direct(batch, sizes)]
            if not all(np.array_equal(a, b) for a, b in zip(out, want)):
                raise AssertionError(f'video {route}: run_streams != the '
                                     'direct call on the same batch')
        print(f'video {route}: 2 streams x {VIDEO_FRAMES} frames of '
              f'{VIDEO_HW[0]} x {VIDEO_HW[1]} on a {list(canvas)} canvas, '
              f'each batch equal to the direct call, launches (nms, stem) '
              f'{counts}; {2 * VIDEO_FRAMES / wall:.1f} frames/s '
              f'({wall:.3f} s wall, {smi})', flush=True)
    try:
        import cv2
    except ImportError:
        print('video: OpenCV (cv2) is absent: the mp4 reader and writer of '
              'infer_video.main not run', flush=True)
        return launches
    videos = []
    for s in range(2):
        path = os.path.join(root, f'stream{s}.mp4')
        sink = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), 25,
                               VIDEO_HW[::-1])
        for frame in streams[s][:3]:
            sink.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        sink.release()
        videos.append(path)
    out_dir = os.path.join(root, 'video_out')
    for k in (nms.nms, stem.bn_relu_pool):
        k.launches = 0
    batches = infer_video.main([ckpt, out_dir, *videos, '--device',
                                device.type])
    launches['nms'] += nms.nms.launches
    launches['stem'] += stem.bn_relu_pool.launches
    for v in videos:
        cap = cv2.VideoCapture(os.path.join(out_dir, os.path.basename(v)))
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if frames != 3:
            raise AssertionError(f'video mp4: {v} -> {frames} frames')
    print(f'video: OpenCV {cv2.__version__}: infer_video.main on two 3-frame '
          f'mp4s wrote both with every frame ({batches} batches)',
          flush=True)
    return launches


# ------------------------------------------------------------ w8a8 (31)

W8A8_BATCHES = 4
W8A8_CALLS = {'ResNet50FPN': 111, 'MobileNetV2FPN': 109}
W8A8_PLAIN_RUNS = 3


def _w8a8_model(ckpt, table_path, device):
    """Phase 4's (or 20's) checkpoint at bf16 with its convolutions swapped
    to w8a8 by the persisted calibration table."""
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.quantize import build_quant_variables

    with open(table_path) as f:
        table = json.load(f)['act_absmax']
    model, _ = Model.load(ckpt, device=device)
    model.set_dtype(torch.bfloat16)
    model.threshold = ENGINE_THRESHOLD
    _, stats = build_quant_variables(model.module, table, mode='w8a8')
    return model, stats


def _hold_convs(label, calls):
    """Every captured call's output (the kernel's, in the main path) equal
    bit for bit to the plain version on the same input; returns the
    count and the largest error (0.0)."""
    from odtk_tpu_torch.ops.kernels import conv_w8a8
    from odtk_tpu_torch.profile_w8a8 import conv_args

    grouped = 0
    for i, (conv, x, y) in enumerate(calls):
        want = conv_w8a8.conv_w8a8_plain(*conv_args(conv, x, y.dtype))
        if not torch.equal(y, want):
            raise AssertionError(
                f'{label}: conv call {i} ({list(x.shape)} {x.dtype} -> '
                f'{list(y.shape)}, groups {conv.groups}) kernel != plain: '
                f'max abs diff {_max_abs([y], [want])}, '
                f'{int((y != want).sum())} elements')
        grouped += conv.groups > 1
    return grouped


def _profiled_ms(fn, keep, runs=5):
    """Device ms per run of ``fn`` summed over the CUDA kernels whose name
    ``keep`` accepts, from a torch.profiler trace of ``runs`` runs."""
    from torch.profiler import ProfilerActivity, profile

    from odtk_tpu_torch.profile_infer import device_events

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in device_events(prof)
             if keep(e.name))
    if not us:
        raise AssertionError('the profiler saw no device time')
    return us / 1e3 / runs


def _conv_times(calls):
    """The w8a8 convolution over one forward's calls: the kernels' device
    ms (profiler), the same calls' event ms (host enqueue included), the
    plain version's ms, bf16 cuDNN ``F.conv2d`` on the same shapes
    (dequantized weights: the yardstick the port never calls) and the
    summed bound."""
    import torch.nn.functional as F

    from odtk_tpu_torch.ops.kernels import conv_w8a8
    from odtk_tpu_torch.profile_w8a8 import conv_args, conv_bound

    args = [conv_args(conv, x, y.dtype) for conv, x, y in calls]

    def kernels():
        for a in args:
            conv_w8a8.conv_w8a8(*a)

    def plain():
        for a in args:
            conv_w8a8.conv_w8a8_plain(*a)

    lib = []
    for conv, x, _ in calls:
        cin_g = x.shape[1] // conv.groups
        w = (conv_w8a8.unpack_weight(conv.weight, cin_g).float()
             * conv.w_scale[:, None, None, None]).to(torch.bfloat16)
        b = None if conv.bias is None else conv.bias.to(torch.bfloat16)
        lib.append((x.to(torch.bfloat16), w.contiguous(), b, conv.stride,
                    conv.padding, 1, conv.groups))

    def library():
        for a in lib:
            F.conv2d(*a)

    ours = ('quantize_nhwc', 'conv_wgmma_kernel', 'conv_finish_kernel',
            'conv_direct_kernel')
    ms = _profiled_ms(kernels, lambda n: any(k in n for k in ours))
    event_ms = _median_ms(kernels, runs=5, warmup=1)
    plain_ms = _median_ms(plain, runs=W8A8_PLAIN_RUNS, warmup=1)
    library_ms = _profiled_ms(library, lambda n: True)
    t_bytes = t_ops = bound = 0.0
    for conv, x, y in calls:
        b_ms, o_ms = conv_bound(conv, x, y)
        bound += max(b_ms, o_ms)
        t_bytes += b_ms if b_ms >= o_ms else 0.0
        t_ops += o_ms if o_ms > b_ms else 0.0
    return dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound=(bound, 'bytes' if t_bytes >= t_ops else 'operations'),
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)


def _counted(fn):
    """Runs ``fn`` with the w8a8, stem and NMS counters set to 0 just
    before; (its result, {kernel: launches})."""
    from odtk_tpu_torch.ops.kernels import conv_w8a8, nms, stem

    counters = {'conv_w8a8': conv_w8a8.conv_w8a8, 'stem': stem.bn_relu_pool,
                'nms': nms.nms}
    for k in counters.values():
        k.launches = 0
    result = fn()
    torch.cuda.synchronize()
    return result, {n: k.launches for n, k in counters.items()}


def _expect(label, launches, batches, calls, stems):
    want = {'conv_w8a8': calls * batches, 'stem': stems * batches,
            'nms': batches}
    if launches != want:
        raise AssertionError(f'{label}: launches {launches}, expected '
                             f'{want} over {batches} batches')


def _finite_detections(label, outs):
    for scores, boxes, _ in outs:
        if not (scores > 0).any(dim=1).all():
            raise AssertionError(f'{label}: an image with no detection')
        if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            raise AssertionError(f'{label}: non-finite detections')


def _batch_ms(fn, batches):
    """Median wall ms a batch of ``fn`` (synchronized), after one warmup."""
    fn(batches[0])
    torch.cuda.synchronize()
    times = []
    for x in batches:
        start = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def w8a8_phase(root, ckpt, mobile_ckpt, img_dir, ann, device, smi,
               engine_ms, int8_err):
    """Phase 31: ``build_quant_variables(mode='w8a8')`` on phase 4's
    ResNet50FPN with phase 11's absmax table at bf16, and the model, its
    engine, the entropy table and phase 20's MobileNetV2FPN through the
    ``odtk::conv_w8a8`` kernel, each conv call held to plain bit for bit;
    then the first batch's calls by call class (``profile_w8a8``) and the
    host us a call. Returns the kernel row and the stem and NMS launches
    of its runs."""
    from odtk_tpu_torch.data import DataIterator
    from odtk_tpu_torch.export import Engine, export_model
    from odtk_tpu_torch.ops.kernels import conv_w8a8
    from odtk_tpu_torch.profile_w8a8 import (capture_calls, class_table,
                                             conv_args, format_table,
                                             host_us)

    table = {name: os.path.join(root, f'axis_export_int8_{name}.calib.json')
             for name in ('absmax', 'entropy')}
    model, stats = _w8a8_model(ckpt, table['absmax'], device)
    iterator = DataIterator(img_dir, 800, 1408, 2, model.stride, 1, ann,
                            training=False, fixed_size=(896, 1408),
                            emit='f32')
    batches = []
    for data, _, _ in iterator:
        batches.append(torch.from_numpy(data).to(device))
        if len(batches) == W8A8_BATCHES:
            break
    nb = len(batches)

    # the model: four batches, every conv call of the first captured
    def run_model():
        calls, first = capture_calls(
            model, lambda: model.inference_fn(batches[0]))
        return calls, [first] + [model.inference_fn(x) for x in batches[1:]]

    (calls, direct), launches = _counted(run_model)
    total = dict(launches)
    _expect('w8a8 model', launches, nb, W8A8_CALLS['ResNet50FPN'], 1)
    _finite_detections('w8a8 model', direct)
    _hold_convs('w8a8 ResNet50FPN', calls)
    dtypes = sorted({str(y.dtype)[6:] for _, _, y in calls})
    conv, x, y = calls[len(calls) // 4]
    x = x.clone()
    x[0, 0, 0, 0], x[0, 1, 1, 1] = float('nan'), float('inf')
    x[-1, -1, -1, -1] = -float('inf')
    args = conv_args(conv, x, y.dtype)
    if not torch.equal(conv_w8a8.conv_w8a8(*args),
                       conv_w8a8.conv_w8a8_plain(*args)):
        raise AssertionError('w8a8: kernel != plain with NaN and +-inf '
                             f'planted in a {list(x.shape)} input')
    print(f'w8a8 model: {stats["quantized_tensors"]} convs swapped, '
          f'{len(calls)} conv calls a forward bit-equal to plain at '
          f'{list(batches[0].shape)} (outputs {dtypes}), and with NaN / '
          f'+-inf planted; launches over {nb} batches {launches}',
          flush=True)

    # the engine of the w8a8 model against the model
    start = time.perf_counter()
    engine = export_model(model, (896, 1408), precision='bf16',
                          dynamic_batch_opts=[2, 2, 2])
    export_s = time.perf_counter() - start
    w8a8_engine_outs, launches = _counted(
        lambda: [engine(x) for x in batches])
    _expect('w8a8 engine', launches, nb, W8A8_CALLS['ResNet50FPN'], 1)
    total = {k: total[k] + launches[k] for k in total}
    score_err, tied = 0.0, 0
    for got, want in zip(w8a8_engine_outs, direct):
        err, ties = top1_rule('w8a8 engine', got, want)
        score_err, tied = max(score_err, err), tied + ties
    print(f'w8a8 engine: exported in {export_s:.1f} s, launches {launches}, '
          f'vs the model scores max err {score_err!r} ({tied} images tied '
          'at the top)', flush=True)

    # the entropy table, one batch
    ent_model, _ = _w8a8_model(ckpt, table['entropy'], device)
    outs, launches = _counted(lambda: [ent_model.inference_fn(batches[0])])
    _expect('w8a8 entropy', launches, 1, W8A8_CALLS['ResNet50FPN'], 1)
    _finite_detections('w8a8 entropy', outs)
    total = {k: total[k] + launches[k] for k in total}
    del ent_model

    # MobileNetV2FPN: phase 20's checkpoint and absmax table, one batch
    mobile, _ = _w8a8_model(mobile_ckpt, os.path.join(
        root, 'axis_mobilenet-export_int8_absmax.calib.json'), device)
    (m_calls, m_outs), launches = _counted(lambda: capture_calls(
        mobile, lambda: [mobile.inference_fn(batches[0])]))
    _expect('w8a8 MobileNetV2FPN', launches, 1,
            W8A8_CALLS['MobileNetV2FPN'], 0)
    _finite_detections('w8a8 MobileNetV2FPN', m_outs)
    grouped = _hold_convs('w8a8 MobileNetV2FPN', m_calls)
    total = {k: total[k] + launches[k] for k in total}
    print(f'w8a8 MobileNetV2FPN: {len(m_calls)} conv calls ({grouped} '
          f'depthwise) bit-equal to plain, launches {launches}', flush=True)
    del mobile, m_calls, m_outs

    # reports: gaps and ms beside phase 11's engines, the kernel's times
    bf16 = Engine.load(engine_path(root, 'axis', 'export', 'bf16'))
    w8a16 = Engine.load(engine_path(root, 'axis', 'export', 'int8_absmax'))
    gap = (0.0, 0.0)
    for x, got in zip(batches, w8a8_engine_outs):
        gap = tuple(map(max, gap, int8_gaps(got, bf16(x))))
    ms = {'w8a8 model': _batch_ms(model.inference_fn, batches),
          'w8a8 engine': _batch_ms(engine, batches),
          'bf16 engine': _batch_ms(bf16, batches),
          'w8a16 engine': _batch_ms(w8a16, batches)}
    row = _conv_times(calls)
    print(f'w8a8 vs the bf16 engine (top-{INT8_TOP_K} scores max err, the '
          f'top-1 class\'s gap to the bf16 top score) on {nb} batches: '
          f'w8a8 {gap}, w8a16 (phase 11, every batch) '
          f'{int8_err.get("int8_absmax")}', flush=True)
    print(f'w8a8 ms per batch (b=2, 896 x 1408, wall, synchronized; {smi}): '
          f'{ms}; phase 11 CLI infer {engine_ms}', flush=True)
    print(f'w8a8 conv per ResNet50FPN forward ({len(calls)} calls; {smi}): '
          f'kernel device {row["ms"]:.4f} ms (events {row["event_ms"]:.4f}), '
          f'bound {row["bound"][0]:.4f} ms by {row["bound"][1]} (bytes-bound '
          f'calls {row["bound_bytes_ms"]:.4f} ms, operation-bound '
          f'{row["bound_ops_ms"]:.4f} ms), plain {row["plain_ms"]:.3f} ms, '
          f'bf16 cuDNN F.conv2d {row["library_ms"]:.4f} ms', flush=True)
    names = {m: n for n, m in model.module.named_modules()}
    classes = class_table(calls, names, batches[0].shape[1])
    print(f'w8a8 conv by call class (device ms a forward, profiler; bound '
          f'per call; {smi}):', flush=True)
    for line in format_table(classes):
        print('  ' + line, flush=True)
    row['host_us'] = host_us([conv_args(conv, x, y.dtype)
                              for conv, x, y in calls])
    row['int_mm'] = classes['1x1 stride-1']
    print(f'w8a8 host us a conv call (111 enqueues, no sync): '
          f'{row["host_us"]:.2f}; the {row["int_mm"]["calls"]} 1x1 '
          f'stride-1 calls: kernel {row["int_mm"]["ms"]:.4f} ms, '
          f'torch._int_mm (cuBLASLt int8 GEMM, A quantized) '
          f'{row["int_mm"]["int_mm_ms"]:.4f} ms', flush=True)
    row['max_abs_err'] = 0.0
    row['calls_per_forward'] = len(calls)
    return row, total


@contextlib.contextmanager
def phase(name):
    """Prints the wall seconds the phase took."""
    start = time.perf_counter()
    yield
    print(f'phase {name}: {time.perf_counter() - start:.1f} s wall',
          flush=True)


def other_phases(name, root, img_dir, ann, device):
    """One model of OTHER_MODELS through the port's entry points:
    ``train`` (the launches of ``expected_launches``), row 5 on its
    first step's levels (``loss_phase``), ``infer`` on the checkpoint,
    NMS on its first batch's candidates (and with a NaN score), then its
    engines and ``infer`` on each (``export_phase``: the stem operator
    absent from a MobileNetV2FPN engine); for MobileNetV2FPN also one
    fp32 SGD step on the card vs the CPU, phase 10's bounds, and its
    depthwise weight gradients (``depthwise_gradient_phase``). Returns
    the numbers the kernel rows and the summary need."""
    backbones, steps, engines = OTHER_MODELS[name]
    stems = sum(BACKBONE_STEMS[b] for b in backbones)
    out = {}
    with phase(f'{name}-train'):
        ckpt, out['train'], levels, _, out['step_ms'], _ = train_phase(
            root, img_dir, ann, backbones=backbones, steps=steps,
            label=f'{name}-train')
    with phase(f'{name}-loss'):
        out['loss'] = loss_phase(levels, f'{name}-loss')
    del levels
    with phase(f'{name}-infer'):
        out['infer'], cands, out['batch_ms'] = e2e_phase(
            root, ckpt, img_dir, ann, stems=stems, label=f'{name}-infer')
    with phase(f'{name}-nms'):
        nms_phase({f'{name}-decode': cands,
                   f'{name}-nan': with_nan_score(*cands)}, timed=())
    if name == 'mobilenet':
        with phase('mobilenet-reference'):
            train_reference_phase(ckpt, device, name='mobilenet-reference')
            depthwise_gradient_phase(ckpt, device)
    with phase(f'{name}-export'):
        out['engine_ms'], out['engine_stem'], _ = export_phase(
            root, ckpt, img_dir, ann, device, names=engines, stems=stems,
            label=f'{name}-export')
    out['ckpt'] = ckpt
    return out


def _times(row):
    return dict(ms=row['ms'], plain_ms=row['plain_ms'],
                bound_ms=row['bound'][0])


def _row(name, source, replaces, launches, row):
    bound_ms, bound_by = row['bound']
    out = dict(name=name, route='cuda', source=source, replaces=replaces,
               launches=launches, max_abs_err=row['max_abs_err'],
               ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=bound_ms,
               bound_by=bound_by, library_ms=row.get('library_ms'))
    out.update({k: row[k] for k in ('engine_shape', 'fp32', 'levels',
                                    'logits', 'cpp_launches', 'event_ms',
                                    'calls_per_forward', 'host_us')
                if k in row})
    if 'int_mm' in row:         # row 10's int8 GEMM yardstick, 1x1 calls
        out.update(int_mm_calls=row['int_mm']['calls'],
                   int_mm_kernel_ms=row['int_mm']['ms'],
                   int_mm_library_ms=row['int_mm']['int_mm_ms'])
    if 'ms_fwd_bwd' in row:     # row 5: the forward alone, and with its
        out.update(              # backward kernel as autograd runs them
            launches_bwd=row['launches_bwd'], ms_fwd_bwd=row['ms_fwd_bwd'],
            plain_ms_fwd_bwd=row['plain_ms_fwd_bwd'],
            bound_ms_fwd_bwd=row['bound_fwd_bwd'][0])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device '
                         '(torch.cuda.is_available() is False)')
    sys.path.insert(0, ROOT)
    from odtk_tpu_torch.ops.kernels import _build

    device = torch.device('cuda', 0)
    smi = card()
    print(f'card: {torch.cuda.get_device_name(0)} ({smi}), torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)
    with phase('build'):
        print(f'kernels: built {os.path.relpath(_build.build(), ROOT)}',
              flush=True)

    with phase('stem'):
        stem_rows = stem_phase(device)
    with phase('stem-train'):
        fwd_rows, bwd_rows = stem_train_phase(device)
    with tempfile.TemporaryDirectory(prefix='odtk_smoke_') as root:
        img_dir, ann = make_data(root, n_images=32)
        with phase('train'):
            ckpt, train_launches, levels, _, step_ms, _ = train_phase(
                root, img_dir, ann)
        with phase('loss'):
            loss_row = loss_phase(levels)
        with phase('focal-sum'):
            focal_fwd, focal_bwd = focal_phase(levels)
        del levels
        with phase('e2e'):
            infer_launches, cands, batch_ms = e2e_phase(root, ckpt, img_dir,
                                                        ann)
        with phase('nms'):
            nms_rows = nms_phase({'decode': cands,
                                  'synthetic': [t.to(device) for t in
                                                synthetic_nms_case()],
                                  'nan': with_nan_score(*cands)})
        with phase('reference'):
            reference_phase(ckpt, device)
        with phase('train-reference'):
            train_reference_phase(ckpt, device)
        with phase('export'):
            engine_ms, engine_stem, int8_err = export_phase(
                root, ckpt, img_dir, ann, device)
        with phase('ckpt'):
            ckpt_launches = ckpt_phase(root, img_dir, ann, device, smi)
        with phase('fused-stem-flags'):
            flag_launches = fused_stem_phase(root, ckpt, img_dir, ann)
        with phase('ddp'):
            ddp_launches = ddp_phase(root, img_dir, ann, ckpt, device, smi)
        other = {name: other_phases(name, root, img_dir, ann, device)
                 for name in OTHER_MODELS}
        with phase('w8a8'):
            w8a8_row, w8a8_launches = w8a8_phase(
                root, ckpt, other['mobilenet']['ckpt'], img_dir, ann, device,
                smi, engine_ms, int8_err)

        rot_root = os.path.join(root, 'rotated')
        rot_dir, rot_ann = make_data(rot_root, n_images=32, rotated=True,
                                     max_boxes=ROTATED_MAX_BOXES)
        with phase('rotated-train'):
            rot_ckpt, rot_launches, levels, snaps, rot_step_ms, _ = \
                train_phase(rot_root, rot_dir, rot_ann, rotated=True)
        with phase('rotated-match'):
            match_row, best_row = rotated_match_phase(snaps)
        with phase('match-l10'):
            match_ten_row = match_ten_phase(snaps)
        del snaps
        with phase('rotated-loss'):
            rot_loss_row = loss_phase(levels, 'rotated-loss')
        del levels
        with phase('multi-rotated-train'):
            _, multi_rot_launches, levels, _, multi_rot_step_ms, _ = \
                train_phase(rot_root, rot_dir, rot_ann, rotated=True,
                            backbones=OTHER_MODELS['multi'][0], steps=2,
                            label='multi-rotated-train')
        with phase('multi-rotated-loss'):
            multi_rot_loss_row = loss_phase(levels, 'multi-rotated-loss')
        del levels
        with phase('rotated-infer'):
            rot_infer_launches, cands, rot_batch_ms = e2e_phase(
                rot_root, rot_ckpt, rot_dir, rot_ann, rotated=True)
        with phase('rotated-nms'):
            rot_nms_rows = rotated_nms_phase(
                {'decode': cands, 'synthetic': [
                    t.to(device) for t in synthetic_rotated_nms_case()],
                 'nan': with_nan_score(*cands)})
        with phase('rotated-train-reference'):
            train_reference_phase(rot_ckpt, device, rotated=True)
        with phase('rotated-export'):
            rot_engine_ms, rot_engine_stem, _ = export_phase(
                rot_root, rot_ckpt, rot_dir, rot_ann, device, rotated=True)
        axis_engine = engine_path(root, 'axis', 'export', 'bf16')
        with phase('cppapi'):
            cpp = cppapi_phase(
                root, ckpt, axis_engine, rot_ckpt,
                engine_path(rot_root, 'rotated', 'rotated-export', 'bf16'),
                img_dir, device, smi)
        with phase('video'):
            video_launches = video_phase(ckpt, axis_engine, img_dir, root,
                                         device, smi)

    csrc = 'odtk_tpu_torch/csrc/'
    pallas = 'odtk_tpu/ops/pallas/'
    bf16 = torch.bfloat16
    kernels = [
        _row('nms', csrc + 'nms.cu', pallas + 'nms_kernel.py:96',
             infer_launches['nms'] + ckpt_launches['infer']['nms']
             + flag_launches['nms'] + ddp_launches['nms']
             + sum(o['infer']['nms'] for o in other.values())
             + cpp['py']['axis'][0] + video_launches['nms']
             + w8a8_launches['nms'],
             dict(nms_rows['decode'], cpp_launches=cpp['cpp']['axis']['nms'])),
        _row('bn_relu_pool', csrc + 'stem_pool.cu',
             pallas + 'stem_kernel.py:99',
             infer_launches['stem'] + rot_infer_launches['stem']
             + ckpt_launches['infer']['stem'] + engine_stem + rot_engine_stem
             + flag_launches['stem'] + ddp_launches['stem']
             + sum(o['infer']['stem'] + o['engine_stem']
                   for o in other.values())
             + sum(py[1] for py in cpp['py'].values())
             + video_launches['stem'] + w8a8_launches['stem'],
             dict(stem_rows[bf16, STEM_SHAPE], max_abs_err=max(
                 r['max_abs_err'] for r in stem_rows.values()),
                  engine_shape=dict(
                      shape=list(ENGINE_STEM_SHAPE),
                      **_times(stem_rows[bf16, ENGINE_STEM_SHAPE])),
                  fp32=_times(stem_rows[torch.float32, STEM_SHAPE]),
                  cpp_launches=sum(c['bn_relu_pool']
                                   for c in cpp['cpp'].values()))),
        _row('bn_relu_pool_idx', csrc + 'stem_pool.cu',
             pallas + 'stem_kernel.py:117',
             train_launches['stem_idx'] + rot_launches['stem_idx']
             + multi_rot_launches['stem_idx']
             + ckpt_launches['train']['stem_idx'] + ddp_launches['stem_idx']
             + sum(o['train']['stem_idx'] for o in other.values()),
             dict(fwd_rows[bf16], fp32=_times(fwd_rows[torch.float32]))),
        _row('bn_relu_pool_bwd', csrc + 'stem_pool.cu',
             pallas + 'stem_kernel.py:157',
             train_launches['stem_bwd'] + rot_launches['stem_bwd']
             + multi_rot_launches['stem_bwd']
             + ckpt_launches['train']['stem_bwd'] + ddp_launches['stem_bwd']
             + sum(o['train']['stem_bwd'] for o in other.values()),
             dict(bwd_rows[bf16], max_abs_err=max(
                 r['max_abs_err'] for r in bwd_rows.values()))),
        _row('det_loss', csrc + 'det_loss.cu',
             pallas + 'focal_kernel.py:186',
             train_launches['det_loss'] + ckpt_launches['train']['det_loss']
             + ddp_launches['det_loss'],
             dict(loss_row, launches_bwd=train_launches['det_loss_bwd']
                  + ckpt_launches['train']['det_loss_bwd']
                  + ddp_launches['det_loss_bwd'])),
    ]
    for name in OTHER_MODELS:
        o = other[name]
        kernels.append(_row(
            f'det_loss_{name}', csrc + 'det_loss.cu',
            pallas + 'focal_kernel.py:186', o['train']['det_loss'],
            dict(o['loss'], launches_bwd=o['train']['det_loss_bwd'])))
    kernels += [
        _row('focal_sum', csrc + 'focal_sum.cu',
             pallas + 'focal_kernel.py:123', 0, focal_fwd[bf16]),
        _row('focal_sum_dx', csrc + 'focal_sum.cu',
             pallas + 'focal_kernel.py:147', 0, focal_bwd[bf16]),
        _row('det_loss_d6', csrc + 'det_loss.cu',
             pallas + 'focal_kernel.py:186', rot_launches['det_loss'],
             dict(rot_loss_row, launches_bwd=rot_launches['det_loss_bwd'])),
        _row('det_loss_d6_l10', csrc + 'det_loss.cu',
             pallas + 'focal_kernel.py:186', multi_rot_launches['det_loss'],
             dict(multi_rot_loss_row,
                  launches_bwd=multi_rot_launches['det_loss_bwd'])),
        _row('match_rotated', csrc + 'match_rotated.cu',
             pallas + 'match_rotated_kernel.py:104',
             rot_launches['match_rotated'], match_row),
        _row('match_rotated_l10', csrc + 'match_rotated.cu',
             pallas + 'match_rotated_kernel.py:104',
             multi_rot_launches['match_rotated'], match_ten_row),
        _row('rotated_best_match', csrc + 'match_rotated.cu',
             pallas + 'iou_kernel.py:79',
             rot_launches['rotated_best_match'], best_row),
        _row('nms_rotated', csrc + 'nms_rotated.cu',
             pallas + 'nms_rotated_kernel.py:92',
             rot_infer_launches['nms_rotated'] + cpp['py']['rotated'][0],
             dict(rot_nms_rows['decode'],
                  cpp_launches=cpp['cpp']['rotated']['nms_rotated'])),
        # no Pallas counterpart: the JAX package's int8 conv is XLA's
        _row('conv_w8a8', csrc + 'conv_w8a8.cu',
             'odtk_tpu/backbones/layers.py:265', w8a8_launches['conv_w8a8'],
             w8a8_row),
    ]
    print(f'e2e_ms_per_batch: {batch_ms}')
    print(f'train_ms_per_step: {step_ms}')
    print(f'rotated_e2e_ms_per_batch: {rot_batch_ms}')
    print(f'rotated_train_ms_per_step: {rot_step_ms}')
    print(f'multi_rotated_train_ms_per_step: {multi_rot_step_ms}')
    print(f'engine_ms_per_batch ({smi}): {engine_ms}')
    print(f'rotated_engine_ms_per_batch ({smi}): {rot_engine_ms}')
    print(f'cppengine_ms_per_inference ({smi}): {cpp["ms"]}')
    for name, o in other.items():
        print(f'{name} ({" + ".join(OTHER_MODELS[name][0])}; {smi}): train '
              f'{o["step_ms"]} ms/step, infer {o["batch_ms"]} ms/batch, '
              f'engines {o["engine_ms"]} ms/batch')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
