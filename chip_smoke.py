#!/usr/bin/env python3
"""Smoke run of odtk_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from ``odtk_tpu_torch/csrc`` (one nvcc per
source, in parallel), drives the port's main paths through its CLI
(``odtk_tpu_torch.main``) on ResNet50FPN at its published widths (80
classes, FPN 256; 9 anchors axis-aligned, 27 rotated with a box head of
6 x 27; random weights from a seed, synthetic COCO JPEGs from
``tests/synth.py``, resize 800 / max 1333, bf16): train, infer, and
export with infer on the engines, axis-aligned and rotated. It holds
each kernel against its plain PyTorch version at the shapes those paths
give it:

  1. card: the device name and power limit;
  2. stem: the primal BN + ReLU + max-pool kernel vs plain at
     [2, 64, 448, 576] (the inference batch), bf16 and fp32, bit-equal;
  3. stem-train: at [8, 64, 448, 576] (the train batch), bf16 and fp32,
     the forward with argmax bit-equal to the primal kernel and to plain,
     its idx equal to max_pool2d's indices mapped to codes, and the
     routing backward equal to the plain version's autograd;
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
  8. nms: the NMS kernel vs plain on the real [2, 2000] candidates of the
     infer run's first batch and on a synthetic [2, 5000] case with
     planted overlaps, ties and an IoU exactly at the threshold: equal;
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
     finite; per step the matcher launched once per level, the loss's
     forward and backward kernels (at D = 6) and the stem's argmax
     forward and backward once;
 13. rotated-match: the matcher kernel vs the plain stream on the real
     anchors and packed targets of the first rotated step's five levels
     (equal wherever the plain best IoU is > 0, <= 0 elsewhere, the
     assignment's depth equal), and its unbatched variant vs plain on
     one image of P3 (equal);
 14. rotated-loss: phase 5 at D = 6 on the first rotated step's heads;
 15. rotated-infer: ``odtk-tpu-torch infer`` on the rotated checkpoint
     (batch 2); the rotated NMS launched once per batch, detections
     non-empty, finite, with a ``segmentation`` polygon;
 16. rotated-nms: the rotated NMS kernel (rank, suppression bitmask,
     scan) vs plain on the real [2, 2000] candidates of that run's first
     batch and on a synthetic [2, 5000] case with tied scores, identical
     boxes, shared corners and a pair next to the threshold: equal; the
     greedy rounds' clips beside the pairs the bitmask clips;
 17. rotated-train-reference: one fp32 rotated SGD step on the card vs
     the CPU at 2 x 256 x 256, with the tolerances of phase 10;
 18. rotated-export: phase 11 for the rotated checkpoint, with a 99.9
     percentile calibration as well, and the rotated NMS's counter.

Any failure raises, and the script exits non-zero. It needs a CUDA
device; without one it fails before printing any result. Kernel times
are medians of 20 runs timed with CUDA events. The line before the card
line holds one JSON object with every kernel's launches, error, times
and bound; before it, the engines' ms per batch beside the card's name
and power limit; the last line is the device summary.
"""

import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
RUNS = 20
STEM_SHAPE = (2, 64, 448, 576)      # conv1 output of a 896x1152 canvas, b=2
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


def stem_phase(device):
    from odtk_tpu_torch.ops.kernels import stem

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        y, scale, shift = _stem_inputs(STEM_SHAPE, dtype, device, 1)
        got = stem.bn_relu_pool(y, scale, shift)
        want = stem.bn_relu_pool_plain(y, scale, shift)
        if not torch.equal(got, want):
            raise AssertionError(
                f'stem kernel != plain in {dtype}: max abs diff '
                f'{_max_abs([got], [want])}')
        conv, pooled = _stem_bytes(STEM_SHAPE, y.element_size())
        rows[dtype] = dict(
            max_abs_err=_max_abs([got], [want]),
            ms=_median_ms(lambda: stem.bn_relu_pool(y, scale, shift)),
            plain_ms=_median_ms(
                lambda: stem.bn_relu_pool_plain(y, scale, shift)),
            bound=_bound(conv + pooled * y.element_size(), 36 * pooled))
        print(f'stem {str(dtype)[6:]} {list(STEM_SHAPE)}: bit-equal, '
              f'kernel {rows[dtype]["ms"]:.4f} ms, plain '
              f'{rows[dtype]["plain_ms"]:.4f} ms, bound '
              f'{rows[dtype]["bound"][0]:.4f} ms', flush=True)
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


def nms_phase(cases):
    from odtk_tpu_torch.ops.kernels import nms

    rows = {}
    for name, (s, b, c) in cases.items():
        got = nms.nms(s, b, c, 0.5, 100)
        want = nms.nms_plain(s, b, c, 0.5, 100)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f'nms kernel != plain on {name}: max abs '
                                 f'diff {_max_abs(got, want)}')
        kept = int((got[0] > 0).sum())
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
        print(f'nms {name} {list(s.shape)}: equal, {kept} kept, kernel '
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


def train_phase(root, img_dir, ann, rotated=False):
    """``odtk-tpu-torch train`` (``--rotated-bbox`` when rotated):
    ResNet50FPN, 80 classes, bf16, b=8, resize 800 / max 1333, from a
    seeded random init. Returns the checkpoint, the launch counts of the
    run, the loss inputs of its first step (for the loss phases), the
    assignment inputs of its first step (for the rotated-match phase),
    the median ms per step and the losses."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import model as model_mod
    from odtk_tpu_torch.ops import assign
    from odtk_tpu_torch.ops.kernels import loss, match_rotated, stem

    kind = 'rotated' if rotated else 'axis'
    ckpt = os.path.join(root, f'retinanet_r50fpn_{kind}_trained.pth')
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
        if len(snaps) < 5:
            snaps.append([a.clone() if torch.is_tensor(a) else a
                          for a in args])
        return assign.snap_to_anchors_rotated_batched(*args)

    # the names loss_fn calls
    model_mod.detection_loss_sums_levels = capture
    model_mod.snap_to_anchors_rotated_batched = capture_snap
    counted = {'det_loss': loss.detection_loss_fwd_kernel,
               'det_loss_bwd': loss.detection_loss_bwd_kernel,
               'stem_idx': stem.bn_relu_pool_idx,
               'stem_bwd': stem.bn_relu_pool_bwd,
               'stem_primal': stem.bn_relu_pool,
               'match_rotated': match_rotated.rotated_match,
               'rotated_best_match': match_rotated.rotated_best_match}
    random.seed(0)                            # the fresh model's init seed
    for k in counted.values():
        k.launches = 0
    try:
        result = cli.main([
            'train', ckpt, '--images', img_dir, '--annotations', ann,
            '--backbone', 'ResNet50FPN', '--classes', '80',
            '--batch', str(TRAIN_BATCH), '--resize', '800',
            '--max-size', '1333', '--jitter', '800', '800',
            '--iters', str(TRAIN_STEPS), '--warmup', str(WARMUP),
            '--milestones', str(TRAIN_STEPS), '--lr', str(TRAIN_LR)]
            + (['--rotated-bbox', '--clip-grads', str(ROTATED_CLIP_GRADS)]
               if rotated else []))
    finally:
        model_mod.detection_loss_sums_levels = loss.detection_loss_sums_levels
        model_mod.snap_to_anchors_rotated_batched = \
            assign.snap_to_anchors_rotated_batched
    launches = {name: k.launches for name, k in counted.items()}
    expect = {'det_loss': TRAIN_STEPS, 'det_loss_bwd': TRAIN_STEPS,
              'stem_idx': TRAIN_STEPS,
              'stem_bwd': TRAIN_STEPS, 'stem_primal': 0,
              'match_rotated': 5 * TRAIN_STEPS if rotated else 0,
              'rotated_best_match': 0}
    if launches != expect:
        raise AssertionError(f'{kind} train launches {launches}, expected '
                             f'{expect}')
    losses = result['losses']
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(c) and math.isfinite(b) for _, c, b in losses):
        raise AssertionError(f'{kind} train losses not finite: {losses}')
    ms = statistics.median(result['step_ms'][3:])
    print(f'{"rotated-" if rotated else ""}train: {TRAIN_STEPS} steps, '
          f'b={TRAIN_BATCH} bf16, launches {launches}, {ms:.3f} ms/step '
          f'(median after 3), loss first {losses[0]} last {losses[-1]}',
          flush=True)
    return ckpt, launches, seen, snaps, ms, losses


# row 5's gradients against autograd of the plain version in float64, as
# row 6's: within one bf16 ulp (2^-7) of the reference rounded to bf16
# (FOCAL_DX_RTOL for fp32 heads), plus LOSS_DX_ATOL times the cotangent
# 1 / fg, far below a background logit's ~2.24e-6 / fg at the -4.6 prior
LOSS_DX_ATOL = 1e-12


def loss_phase(levels, label='loss'):
    """Row 5 on the first train step's five levels (bf16 heads; D = 4, or
    6 for the rotated model): the forward kernel alone, and forward +
    backward as ``Model.loss_fn`` runs them (``torch.autograd.grad`` of
    its loss, the level sums over the foreground count fg, to the heads),
    against the plain version a level at a time. Sums: relative 1e-4
    (fp32 sums of ~1e8 terms in two orders). Gradients: elementwise
    against the plain version's autograd in float64 (an image at a time),
    within one bf16 ulp of it rounded to bf16, plus LOSS_DX_ATOL / fg.
    Times are per step."""
    from odtk_tpu_torch.ops.kernels import loss

    cls_heads, box_heads, cls_ts, box_ts, depths, classes = (
        list(t) for t in zip(*levels))
    classes = classes[0]
    fg = sum(max(int((d > 0).sum()), 1) for d in depths)
    ops, geo = loss.kernel_operands(cls_heads, box_heads, cls_ts, box_ts,
                                    depths, classes)
    sums = loss.detection_loss_fwd_kernel(ops, geo, classes)

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
        ms=_median_ms(lambda: loss.detection_loss_fwd_kernel(
            *loss.kernel_operands(cls_heads, box_heads, cls_ts, box_ts,
                                  depths, classes), classes)),
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
    row['bound_fwd_bwd'] = _bound(read + 8 * len(levels)
                                  + (logits + boxes) * s,
                                  58 * logits + 16 * fg_boxes)
    print(f'{label}: {len(levels)} levels, forward kernel {row["ms"]:.4f} ms '
          f'(plain {row["plain_ms"]:.4f}, bound {row["bound"][0]:.4f}); '
          f'forward + backward {row["ms_fwd_bwd"]:.4f} ms (plain '
          f'{row["plain_ms_fwd_bwd"]:.4f}, bound '
          f'{row["bound_fwd_bwd"][0]:.4f}) per step', flush=True)
    return row


def e2e_phase(root, ckpt, img_dir, ann, rotated=False):
    """The ``infer`` CLI on the synthetic set with the trained checkpoint
    (a rotated model by the checkpoint's angles). Returns the launch
    counts of the run, the NMS inputs of its first batch (for the NMS
    phases) and its median ms per batch after the first."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import model as model_mod
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    kind = 'rotated' if rotated else 'axis'
    det = os.path.join(root, f'detections_{kind}.json')
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
    if (launches[name] != batches or launches['stem'] != batches
            or launches[other] != 0):
        raise AssertionError(f'{kind} e2e launches {launches} over '
                             f'{batches} batches')
    with open(det) as f:
        dets = json.load(f)['annotations']
    if not dets:
        raise AssertionError(f'no {kind} detections')
    for d in dets:
        values = d['bbox'] + [d['score']]
        if rotated:
            if len(d['bbox']) != 5 or len(d['segmentation'][0]) != 8:
                raise AssertionError(f'not a rotated detection: {d}')
            values += d['segmentation'][0]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f'non-finite detection {d}')
    ms = statistics.median(result['batch_ms'][1:])
    print(f'{"rotated-infer" if rotated else "e2e"}: {len(dets)} '
          f'detections, launches {launches}, {ms:.3f} ms/batch (b=2, bf16)',
          flush=True)
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
    result = []
    for dev in devices:
        model, _ = Model.load(ckpt, device=dev)
        params = dict(model.module.named_parameters())
        opt = train.make_optimizer(params.values(), lr)
        step = train.make_train_step(model, opt, feed='u8')
        cl, bl = step(lr, *(t.to(dev) for t in (u8, targets, colors,
                                                sizes)))
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


def train_reference_phase(ckpt, device, rotated=False):
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
    name = 'rotated-train-reference' if rotated else 'train-reference'
    e = reference_errors(ckpt, ('cpu', device), rotated)
    print(f'{name}: fp32 step card vs CPU, losses rel err {e["loss"]:.3g}; '
          f'parameter update rel L2 err over all {e["total"]:.3g}, median '
          f'tensor {e["median"]:.3g}, largest {e["worst_err"]:.3g} '
          f'({e["worst"]})', flush=True)
    if (e['loss'] > 1e-4 or e['total'] > 5e-3 or e['median'] > 5e-3
            or e['worst_err'] > 5e-2):
        raise AssertionError(f'{name} card vs CPU out of bounds: {e}')


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


def rotated_match_phase(snaps):
    """The matcher kernel vs the plain stream on the real anchors and
    packed targets of the first rotated step's five levels: equal IoU and
    slot wherever the plain best IoU is > 0, <= 0 elsewhere, and the
    assignment's depth equal. Then the unbatched variant vs plain on the
    first image of P3: equal everywhere."""
    from odtk_tpu_torch.ops import assign, iou_rotated
    from odtk_tpu_torch.ops.kernels import match_rotated as km

    k_ms = p_ms = bound_ms = 0.0
    pairs_total = 0
    for targets, size, stride, table, classes, ious in snaps:
        _, quads, cls, valid, _, boxes_rot = assign.rotated_level(
            targets.float(), size, stride, table)
        subj, rows, n_act = iou_rotated.match_inputs(quads, boxes_rot, valid,
                                                     ious[0])
        got = km.rotated_match(subj, rows, n_act)
        want = km.rotated_match_plain(subj, rows, n_act)
        hit = want[0] > 0
        if not (torch.equal(got[0][hit], want[0][hit])
                and torch.equal(got[1][hit], want[1][hit])
                and bool((got[0][~hit] <= 0).all())):
            raise AssertionError(f'match kernel != plain at stride {stride}')
        depths = [assign._depth_and_class(
            iou, torch.gather(cls, 1, slot.long()), classes, ious)[1]
            for iou, slot in (got, want)]
        if not torch.equal(*depths):
            raise AssertionError(f'assignment depth differs at stride '
                                 f'{stride}')
        pairs = _aabb_pairs(subj, rows, n_act)
        pairs_total += pairs
        k_ms += _median_ms(lambda: km.rotated_match(subj, rows, n_act))
        p_ms += _median_ms(lambda: km.rotated_match_plain(subj, rows, n_act),
                           runs=3, warmup=1)
        b, n = want[0].shape
        bound_ms += _bound(subj.numel() * 4 + rows.numel() * 4 + b * 4
                           + b * n * 8, pairs * CLIP_OPS)[0]
        print(f'rotated-match stride {stride} [{b}, {n}] x {n_act.tolist()} '
              f'targets: IoU > 0 at {int(hit.sum())} (equal), kernel at -2 '
              f'{int((got[0] == -2).sum())} vs plain '
              f'{int((want[0] == -2).sum())}, foreground '
              f'{int((depths[0] > 0).sum())}, AABB pairs {pairs}',
              flush=True)
    print(f'rotated-match: 5 levels, kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.4f} ms, bound {bound_ms:.4f} ms per step', flush=True)
    match_row = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                     bound=(bound_ms, 'operations'), pairs=pairs_total)

    targets, size, stride, table, _, _ = snaps[0]
    _, quads, _, valid, _, boxes_rot = assign.rotated_level(
        targets.float(), size, stride, table)
    args = (quads, boxes_rot[0], valid[0])
    got = km.rotated_best_match(*args)
    want = km.rotated_best_match_plain(*args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError('rotated_best_match kernel != plain')
    n, m = quads.shape[0], boxes_rot.shape[1]
    best_row = dict(
        max_abs_err=0.0, ms=_median_ms(lambda: km.rotated_best_match(*args)),
        plain_ms=_median_ms(lambda: km.rotated_best_match_plain(*args),
                            runs=3, warmup=1),
        bound=_bound(n * 32 + m * 36 + n * 8,
                     n * int(valid[0].sum()) * CLIP_OPS))
    print(f'rotated_best_match [{n}] x {m} (P3, image 0): equal, kernel '
          f'{best_row["ms"]:.4f} ms, plain {best_row["plain_ms"]:.4f} ms, '
          f'bound {best_row["bound"][0]:.4f} ms', flush=True)
    return match_row, best_row


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


def rotated_nms_phase(cases):
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


def export_phase(root, ckpt, img_dir, ann, device, rotated=False):
    """``odtk-tpu-torch export`` of the trained checkpoint: bf16 with batch
    profiles 1 and 2, fp32, and INT8 calibrated on the synthetic JPEGs
    with absmax and with entropy (and, rotated, a 99.9 percentile), then
    ``odtk-tpu-torch infer`` on each engine (batch 2). Checks: non-empty,
    finite detection JSONs; the NMS (rotated NMS) and stem counters rose
    by one per batch during each engine's run; the bf16 engine's
    detections equal the checkpoint path's on the same f32 batches at the
    engine geometry (scores within 1e-3, the same top-1 class and box to
    0.5 px per image); on the first batch, the stem and NMS kernels equal
    their plain versions on the inputs the bf16 and fp32 engines give
    them; each int8 engine near the bf16 one on every batch
    (``int8_check``); each int8 package under the fp32 one / 2.5.
    Returns {engine: ms per batch}."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch.data import DataIterator, RotatedDataIterator
    from odtk_tpu_torch.export import Engine
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    kind = 'rotated' if rotated else 'axis'
    label = 'rotated-export' if rotated else 'export'
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
    paths, sizes, ms = {}, {}, {}
    for name, flags in flavours.items():
        path = os.path.join(root, f'{kind}_{name}.engine')
        table = os.path.join(root, f'{kind}_{name}.calib.json')
        start = time.perf_counter()
        cli.main(['export', ckpt, path, '--size', *ENGINE_SIZE,
                  '--threshold', str(ENGINE_THRESHOLD),
                  '--calibration-table', table, *flags])
        export_s = time.perf_counter() - start
        paths[name], sizes[name] = path, os.path.getsize(path)

        det = os.path.join(root, f'detections_{kind}_{name}.json')
        for k in (nms_fn, other, stem.bn_relu_pool):
            k.launches = 0
        result = cli.main(['infer', path, '--images', img_dir,
                           '--annotations', ann, '--batch', '2',
                           '--output', det])
        batches = len(result['batch_ms'])
        launches = (nms_fn.launches, stem.bn_relu_pool.launches,
                    other.launches)
        if launches != (batches, batches, 0):
            raise AssertionError(f'{label} {name}: launches (nms, stem, '
                                 f'other nms) {launches} over {batches} '
                                 'batches: the engine did not run the '
                                 'kernels')
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
        if name.startswith('int8') and sizes[name] >= sizes['fp32'] / 2.5:
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
                engine_kernels_check(f'{label} {name}', engines[name], x,
                                     rotated)
        got = engine(x)
        want = model.inference_fn(x)
        for name in int8_err:
            int8_err[name] = tuple(map(max, int8_err[name], int8_check(
                f'{label} {name}', engines[name](x), got)))
        score_err = max(score_err, (got[0] - want[0]).abs().max().item())
        for i in range(x.shape[0]):
            # a model 20 steps from random weights gives many detections
            # the same bf16 score: the top-1 is any of those tied at the top
            top = want[0][i] == want[0][i, 0]
            tied += int(top.sum()) > 1
            box_err = (got[1][i, 0] - want[1][i][top]).abs().amax(-1)
            ok = (box_err <= 0.5) & (want[2][i][top] == got[2][i, 0])
            if not bool(ok.any()):
                raise AssertionError(
                    f'{label}: engine top-1 (class {got[2][i, 0].item()}, '
                    f'score {got[0][i, 0].item()!r}, box '
                    f'{got[1][i, 0].tolist()}) is none of the checkpoint '
                    f'path\'s {int(top.sum())} at its top score '
                    f'{want[0][i, 0].item()!r} (box errs {box_err.tolist()})')
        compared += x.shape[0]
    if score_err > 1e-3:
        raise AssertionError(f'{label}: engine scores off the checkpoint '
                             f'path by {score_err}')
    print(f'{label}: bf16 engine vs checkpoint path on {compared} images at '
          f'{list(engine.input_size)}: scores max err {score_err!r}, top-1 '
          f'class and box equal ({tied} images with a tie at the top); '
          f'int8 engines vs bf16 (top-{INT8_TOP_K} scores max err, the '
          f'int8 top-1 class\'s gap to the bf16 top score) {int8_err}; '
          f'package bytes {sizes}', flush=True)
    return ms


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


def engine_kernels_check(label, engine, x, rotated):
    """The stem and NMS (rotated NMS) kernels on the tensors the engine
    itself gives them on batch x (its conv1 output at the engine geometry,
    the decode candidates of its heads), each equal to its plain
    version."""
    from odtk_tpu_torch.ops.kernels import nms, nms_rotated, stem

    with _OperatorInputs() as inputs:
        engine(x)
    y, scale, shift = inputs.seen['odtk::bn_relu_pool']
    if not torch.equal(stem.bn_relu_pool(y, scale, shift),
                       stem.bn_relu_pool_plain(y, scale, shift)):
        raise AssertionError(f'{label}: stem kernel != plain on the '
                             f'engine\'s {list(y.shape)} {y.dtype} input')
    op, fn, plain = (('odtk::nms_rotated', nms_rotated.nms_rotated,
                      nms_rotated.nms_rotated_plain) if rotated else
                     ('odtk::nms', nms.nms, nms.nms_plain))
    args = inputs.seen[op]
    got, want = fn(*args), plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f'{label}: {op} kernel != plain on the '
                             f'engine\'s candidates: max abs diff '
                             f'{_max_abs(got, want)}')
    print(f'{label}: the stem kernel on the engine\'s {list(y.shape)} '
          f'{str(y.dtype)[6:]} conv1 output and {op[6:]} on its '
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


def int8_check(label, got, ref):
    """Int8 detections ``got`` against the bf16 engine's ``ref`` on one
    batch: (the largest top-k score error, the largest gap between the
    bf16 top score and the bf16 engine's best score for the int8 top-1
    class); raises where either passes INT8_SCORE_TOL."""
    err = (got[0][:, :INT8_TOP_K] - ref[0][:, :INT8_TOP_K]).abs().max().item()
    gap = 0.0
    for i in range(ref[0].shape[0]):
        same = ref[0][i][ref[2][i] == got[2][i, 0]]
        gap = max(gap, (ref[0][i, 0] - same.max()).item() if same.numel()
                  else math.inf)
    if not max(err, gap) <= INT8_SCORE_TOL:
        raise AssertionError(f'{label}: top-{INT8_TOP_K} scores off the bf16 '
                             f'engine\'s by {err!r}, top-1 class {gap!r} '
                             'below its top score')
    return err, gap


def _row(name, source, replaces, launches, row):
    bound_ms, bound_by = row['bound']
    out = dict(name=name, route='cuda', source=source, replaces=replaces,
               launches=launches, max_abs_err=row['max_abs_err'],
               ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
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
    print(f'kernels: built {os.path.relpath(_build.build(), ROOT)}',
          flush=True)

    stem_rows = stem_phase(device)
    fwd_rows, bwd_rows = stem_train_phase(device)
    with tempfile.TemporaryDirectory(prefix='odtk_smoke_') as root:
        img_dir, ann = make_data(root, n_images=32)
        ckpt, train_launches, levels, _, step_ms, _ = train_phase(
            root, img_dir, ann)
        loss_row = loss_phase(levels)
        focal_fwd, focal_bwd = focal_phase(levels)
        del levels
        infer_launches, cands, batch_ms = e2e_phase(root, ckpt, img_dir,
                                                    ann)
        nms_rows = nms_phase({'decode': cands,
                              'synthetic': [t.to(device) for t in
                                            synthetic_nms_case()]})
        reference_phase(ckpt, device)
        train_reference_phase(ckpt, device)
        engine_ms = export_phase(root, ckpt, img_dir, ann, device)

        rot_root = os.path.join(root, 'rotated')
        rot_dir, rot_ann = make_data(rot_root, n_images=32, rotated=True,
                                     max_boxes=ROTATED_MAX_BOXES)
        rot_ckpt, rot_launches, levels, snaps, rot_step_ms, _ = train_phase(
            rot_root, rot_dir, rot_ann, rotated=True)
        match_row, best_row = rotated_match_phase(snaps)
        del snaps
        rot_loss_row = loss_phase(levels, 'rotated-loss')
        del levels
        rot_infer_launches, cands, rot_batch_ms = e2e_phase(
            rot_root, rot_ckpt, rot_dir, rot_ann, rotated=True)
        rot_nms_rows = rotated_nms_phase(
            {'decode': cands, 'synthetic': [
                t.to(device) for t in synthetic_rotated_nms_case()]})
        train_reference_phase(rot_ckpt, device, rotated=True)
        rot_engine_ms = export_phase(rot_root, rot_ckpt, rot_dir, rot_ann,
                                     device, rotated=True)

    csrc = 'odtk_tpu_torch/csrc/'
    pallas = 'odtk_tpu/ops/pallas/'
    bf16 = torch.bfloat16
    kernels = [
        _row('nms', csrc + 'nms.cu', pallas + 'nms_kernel.py:96',
             infer_launches['nms'], nms_rows['decode']),
        _row('bn_relu_pool', csrc + 'stem_pool.cu',
             pallas + 'stem_kernel.py:99', infer_launches['stem'],
             dict(stem_rows[bf16], max_abs_err=max(
                 r['max_abs_err'] for r in stem_rows.values()))),
        _row('bn_relu_pool_idx', csrc + 'stem_pool.cu',
             pallas + 'stem_kernel.py:117',
             train_launches['stem_idx'], fwd_rows[bf16]),
        _row('bn_relu_pool_bwd', csrc + 'stem_pool.cu',
             pallas + 'stem_kernel.py:157',
             train_launches['stem_bwd'], dict(bwd_rows[bf16], max_abs_err=max(
                 r['max_abs_err'] for r in bwd_rows.values()))),
        _row('det_loss', csrc + 'det_loss.cu',
             pallas + 'focal_kernel.py:186', train_launches['det_loss'],
             dict(loss_row, launches_bwd=train_launches['det_loss_bwd'])),
        _row('focal_sum', csrc + 'focal_sum.cu',
             pallas + 'focal_kernel.py:123', 0, focal_fwd[bf16]),
        _row('focal_sum_dx', csrc + 'focal_sum.cu',
             pallas + 'focal_kernel.py:147', 0, focal_bwd[bf16]),
        _row('det_loss_d6', csrc + 'det_loss.cu',
             pallas + 'focal_kernel.py:186', rot_launches['det_loss'],
             dict(rot_loss_row, launches_bwd=rot_launches['det_loss_bwd'])),
        _row('match_rotated', csrc + 'match_rotated.cu',
             pallas + 'match_rotated_kernel.py:104',
             rot_launches['match_rotated'], match_row),
        _row('rotated_best_match', csrc + 'match_rotated.cu',
             pallas + 'iou_kernel.py:79',
             rot_launches['rotated_best_match'], best_row),
        _row('nms_rotated', csrc + 'nms_rotated.cu',
             pallas + 'nms_rotated_kernel.py:92',
             rot_infer_launches['nms_rotated'], rot_nms_rows['decode']),
    ]
    print(f'e2e_ms_per_batch: {batch_ms}')
    print(f'train_ms_per_step: {step_ms}')
    print(f'rotated_e2e_ms_per_batch: {rot_batch_ms}')
    print(f'rotated_train_ms_per_step: {rot_step_ms}')
    print(f'engine_ms_per_batch ({smi}): {engine_ms}')
    print(f'rotated_engine_ms_per_batch ({smi}): {rot_engine_ms}')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
