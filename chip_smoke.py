#!/usr/bin/env python3
"""Smoke run of odtk_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from ``odtk_tpu_torch/csrc`` (one nvcc per
source, in parallel), drives the port's two main paths through its CLI
(``odtk_tpu_torch.main``) on ResNet50FPN at its published widths (80
classes, 9 anchors, FPN 256, random weights from a seed, synthetic COCO
JPEGs from ``tests/synth.py``, resize 800 / max 1333, bf16), and holds
each of the five kernels against its plain PyTorch version at the shapes
those paths give it:

  1. card: the device name and power limit;
  2. stem: the primal BN + ReLU + max-pool kernel vs plain at
     [2, 64, 448, 576] (the inference batch), bf16 and fp32, bit-equal;
  3. stem-train: at [8, 64, 448, 576] (the train batch), bf16 and fp32,
     the forward with argmax bit-equal to the primal kernel and to plain,
     its idx equal to max_pool2d's indices mapped to codes, and the
     routing backward equal to the plain version's autograd;
  4. train: ``odtk-tpu-torch train`` for 20 steps at batch 8 (lr 0.001,
     warmup 10), from a seeded random init; the losses finite, each of
     the three training kernels launched the expected number of times;
  5. loss: the fused loss kernel vs plain on the real heads and targets
     of the first train step's five levels: sums within a relative 1e-4,
     unit gradients elementwise;
  6. infer: ``odtk-tpu-torch infer`` on the checkpoint the train phase
     wrote (batch 2); NMS and the primal stem launched, detections
     non-empty and finite;
  7. nms: the NMS kernel vs plain on the real [2, 2000] candidates of the
     infer run's first batch and on a synthetic [2, 5000] case with
     planted overlaps, ties and an IoU exactly at the threshold: equal;
  8. reference: fp32 inference on the card (TF32 off) vs the CPU;
  9. train-reference: one fp32 SGD step of ResNet50FPN on the card (TF32
     off) vs the same step on the CPU, at 2 x 256 x 256.

Any failure raises, and the script exits non-zero. It needs a CUDA
device; without one it fails before printing any result. Kernel times
are medians of 20 runs timed with CUDA events. The line before the card
line holds one JSON object with every kernel's launches, error, times
and bound; the last line is the device summary.
"""

import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RUNS = 20
STEM_SHAPE = (2, 64, 448, 576)      # conv1 output of a 896x1152 canvas, b=2
TRAIN_STEM_SHAPE = (8, 64, 448, 576)
TRAIN_BATCH, TRAIN_STEPS, WARMUP = 8, 20, 10
# from random weights (the port fetches no pretrained backbone) the
# unnormalized ResNet50 diverges within 20 steps at lr 0.01 on the card
TRAIN_LR = 0.001
HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM device memory, bytes / ms
FP32_FLOPS_PER_MS = 67e12 / 1e3      # H100 SXM fp32 outside tensor cores


def _median_ms(fn, runs=RUNS):
    for _ in range(3):
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


def make_data(root, n_images):
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from synth import make_dataset

    img_dir, ann = make_dataset(root, n_images=n_images, size=(480, 640),
                                seed=0, fmt='jpg')
    # an 80-class model: give the ground truth 80 categories so every
    # predicted class maps to a category id
    with open(ann) as f:
        data = json.load(f)
    data['categories'] = [{'id': i + 1, 'name': f'class{i}'}
                          for i in range(80)]
    with open(ann, 'w') as f:
        json.dump(data, f)
    return img_dir, ann


def train_phase(root, img_dir, ann):
    """``odtk-tpu-torch train``: ResNet50FPN, 80 classes, bf16, b=8,
    resize 800 / max 1333, from a seeded random init. Returns the
    checkpoint, the launch counts of the run, the loss inputs of its
    first step (for the loss phase) and the median ms per step."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import model as model_mod
    from odtk_tpu_torch.ops.kernels import loss, stem

    ckpt = os.path.join(root, 'retinanet_r50fpn_trained.pth')
    seen = []

    def capture(*args, **kwargs):
        if len(seen) < 5:
            seen.append([a.detach().clone() if torch.is_tensor(a) else a
                         for a in args])
        return loss.detection_loss_sums(*args, **kwargs)

    model_mod.detection_loss_sums = capture   # the name loss_fn calls
    kernels = (loss.detection_loss_sums, stem.bn_relu_pool_idx,
               stem.bn_relu_pool_bwd, stem.bn_relu_pool)
    random.seed(0)                            # the fresh model's init seed
    for k in kernels:
        k.launches = 0
    try:
        result = cli.main([
            'train', ckpt, '--images', img_dir, '--annotations', ann,
            '--backbone', 'ResNet50FPN', '--classes', '80',
            '--batch', str(TRAIN_BATCH), '--resize', '800',
            '--max-size', '1333', '--jitter', '800', '800',
            '--iters', str(TRAIN_STEPS), '--warmup', str(WARMUP),
            '--milestones', str(TRAIN_STEPS), '--lr', str(TRAIN_LR)])
    finally:
        model_mod.detection_loss_sums = loss.detection_loss_sums
    launches = {'det_loss': loss.detection_loss_sums.launches,
                'stem_idx': stem.bn_relu_pool_idx.launches,
                'stem_bwd': stem.bn_relu_pool_bwd.launches,
                'stem_primal': stem.bn_relu_pool.launches}
    expect = {'det_loss': 5 * TRAIN_STEPS, 'stem_idx': TRAIN_STEPS,
              'stem_bwd': TRAIN_STEPS, 'stem_primal': 0}
    if launches != expect:
        raise AssertionError(f'train launches {launches}, expected {expect}')
    losses = result['losses']
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(c) and math.isfinite(b) for _, c, b in losses):
        raise AssertionError(f'train losses not finite: {losses}')
    ms = statistics.median(result['step_ms'][3:])
    print(f'train: {TRAIN_STEPS} steps, b={TRAIN_BATCH} bf16, launches '
          f'{launches}, {ms:.3f} ms/step (median after 3), loss first '
          f'{losses[0]} last {losses[-1]}', flush=True)
    return ckpt, launches, seen, ms, losses


def loss_phase(levels):
    """The fused loss kernel vs plain on the first train step's five
    levels (bf16 heads). Sums: relative 1e-4 (fp32 sums of ~1e8 terms
    in two orders). Unit gradients: one bf16 ulp (rtol 2^-7), both
    rounded once from fp32."""
    from odtk_tpu_torch.ops.kernels import loss

    k_ms = p_ms = bound_ms = 0.0
    err = 0.0
    for cls_head, box_head, cls_t, box_t, depth, classes in levels:
        sums, dx, dbx = loss.detection_loss_sums_kernel(
            cls_head, box_head, cls_t, box_t, depth, classes)
        xr = cls_head.detach().requires_grad_(True)
        bxr = box_head.detach().requires_grad_(True)
        c_sum, b_sum = loss.detection_loss_sums_plain(
            xr, bxr, cls_t, box_t, depth, classes)
        want_dx, want_dbx = torch.autograd.grad(c_sum + b_sum, (xr, bxr))
        for got, want in ((sums[0], c_sum), (sums[1], b_sum)):
            rel = abs(got.item() - want.item()) / max(abs(want.item()),
                                                      1e-30)
            if rel > 1e-4:
                raise AssertionError(f'loss sums rel err {rel:.3g}')
        torch.testing.assert_close(dx, want_dx, rtol=2 ** -7, atol=1e-6)
        torch.testing.assert_close(dbx, want_dbx, rtol=2 ** -7, atol=1e-6)
        err = max(err, _max_abs([sums[0], sums[1], dx, dbx],
                                [c_sum.detach(), b_sum.detach(), want_dx,
                                 want_dbx]))

        def plain():
            xp = cls_head.detach().requires_grad_(True)
            bp = box_head.detach().requires_grad_(True)
            cs, bs = loss.detection_loss_sums_plain(xp, bp, cls_t, box_t,
                                                    depth, classes)
            torch.autograd.grad(cs + bs, (xp, bp))

        k_ms += _median_ms(lambda: loss.detection_loss_sums_kernel(
            cls_head, box_head, cls_t, box_t, depth, classes))
        p_ms += _median_ms(plain)
        s = cls_head.element_size()
        n = depth.numel()
        logits = cls_head.numel()
        nbytes = (2 * logits * s + 2 * box_head.numel() * s
                  + n * (4 + 4 + 16) + 8)
        bound_ms += _bound(nbytes, 33 * logits + 12 * box_head.numel())[0]
        print(f'loss level {list(cls_head.shape)}: sums {sums.tolist()} vs '
              f'plain {[c_sum.item(), b_sum.item()]}, unit gradients within '
              f'one bf16 ulp', flush=True)
    print(f'loss: 5 levels, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
          f'bound {bound_ms:.4f} ms per step', flush=True)
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                bound=(bound_ms, 'bytes'))


def e2e_phase(root, ckpt, img_dir, ann):
    """The ``infer`` CLI on the synthetic set with the trained checkpoint.
    Returns the launch counts of the run, the NMS inputs of its first
    batch (for the NMS phase) and its median ms per batch after the
    first."""
    from odtk_tpu_torch import main as cli
    from odtk_tpu_torch import model as model_mod
    from odtk_tpu_torch.ops.kernels import nms, stem

    det = os.path.join(root, 'detections.json')
    seen = []

    def capture(scores, boxes, classes, *args):
        if not seen:
            seen.extend((scores, boxes, classes))
        return nms.nms(scores, boxes, classes, *args)

    model_mod.nms = capture     # the name Model.inference_fn calls
    nms.nms.launches = stem.bn_relu_pool.launches = 0
    try:
        result = cli.main(['infer', ckpt, '--images', img_dir,
                           '--annotations', ann, '--batch', '2',
                           '--threshold', '0.001', '--output', det])
    finally:
        model_mod.nms = nms.nms
    launches = {'nms': nms.nms.launches, 'stem': stem.bn_relu_pool.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f'the {name} kernel never launched in the '
                                 'end-to-end run')
    with open(det) as f:
        dets = json.load(f)['annotations']
    if not dets:
        raise AssertionError('no detections')
    for d in dets:
        if not all(math.isfinite(v) for v in d['bbox'] + [d['score']]):
            raise AssertionError(f'non-finite detection {d}')
    ms = statistics.median(result['batch_ms'][1:])
    print(f'e2e: {len(dets)} detections, launches {launches}, '
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


def train_reference_phase(ckpt, device):
    """One fp32 SGD step (lr 0.01, momentum 0.9, weight decay 1e-4) of
    ResNet50FPN from the trained checkpoint on the card (TF32 off) and
    on the CPU, on the same two 256x256 u8 images and targets.

    Losses within a relative 1e-4. The parameter change is compared as
    the update the step applies, lr x the momentum buffer (the first
    step's buffer is the gradient plus the weight decay), before it is
    rounded into the parameter's fp32 ulp, by relative L2 error: over
    all parameters within 2e-3, the median tensor within 1e-3 (fp32
    convolutions summed in other orders through the network and its
    backward), and every tensor within 5e-2. A ReLU or max-pool decision
    on a value near 0 can go either way between the two sums, and one
    such flip in layer4 (2 x 8 x 8 positions per channel at 256x256)
    moves a weight's gradient by ~1/128 of it; a gradient path that is
    wrong or missing moves its tensors by order 1."""
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
    result = {}
    for dev in ('cpu', device):
        model, _ = Model.load(ckpt, device=dev)
        params = dict(model.module.named_parameters())
        opt = train.make_optimizer(params.values(), lr)
        step = train.make_train_step(model, opt, feed='u8')
        cl, bl = step(lr, *(t.to(dev) for t in (u8, targets, colors,
                                                sizes)))
        result[dev] = ((cl.item(), bl.item()),
                       {k: lr * opt.state[p]['momentum_buffer'].double().cpu()
                        for k, p in params.items()})
    (c0, b0), u0 = result['cpu']
    (c1, b1), u1 = result[device]
    loss_err = max(abs(c1 - c0) / abs(c0), abs(b1 - b0) / abs(b0))
    per = {k: ((u1[k] - u0[k]).norm() / u0[k].norm().clamp(min=1e-30))
           .item() for k in u0}
    total = (sum(((u1[k] - u0[k]) ** 2).sum() for k in u0)
             / sum((u0[k] ** 2).sum() for k in u0)).sqrt().item()
    median = statistics.median(per.values())
    worst = max(per, key=per.get)
    print(f'train-reference: fp32 step card vs CPU, losses rel err '
          f'{loss_err:.3g}; parameter update rel L2 err over all '
          f'{total:.3g}, median tensor {median:.3g}, largest {per[worst]:.3g} '
          f'({worst})', flush=True)
    if (loss_err > 1e-4 or total > 2e-3 or median > 1e-3
            or per[worst] > 5e-2):
        raise AssertionError(
            f'train step card vs CPU: losses {loss_err:.3g}, update all '
            f'{total:.3g}, median {median:.3g}, {worst} {per[worst]:.3g}')


def _row(name, source, replaces, launches, row):
    bound_ms, bound_by = row['bound']
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                launches=launches, max_abs_err=row['max_abs_err'],
                ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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
        ckpt, train_launches, levels, step_ms, losses = train_phase(
            root, img_dir, ann)
        loss_row = loss_phase(levels)
        del levels
        infer_launches, cands, batch_ms = e2e_phase(root, ckpt, img_dir,
                                                    ann)
        nms_rows = nms_phase({'decode': cands,
                              'synthetic': [t.to(device) for t in
                                            synthetic_nms_case()]})
        reference_phase(ckpt, device)
        train_reference_phase(ckpt, device)

    csrc = 'odtk_tpu_torch/csrc/'
    bf16 = torch.bfloat16
    kernels = [
        _row('nms', csrc + 'nms.cu', 'odtk_tpu/ops/pallas/nms_kernel.py:96',
             infer_launches['nms'], nms_rows['decode']),
        _row('bn_relu_pool', csrc + 'stem_pool.cu',
             'odtk_tpu/ops/pallas/stem_kernel.py:99', infer_launches['stem'],
             dict(stem_rows[bf16], max_abs_err=max(
                 r['max_abs_err'] for r in stem_rows.values()))),
        _row('bn_relu_pool_idx', csrc + 'stem_pool.cu',
             'odtk_tpu/ops/pallas/stem_kernel.py:117',
             train_launches['stem_idx'], fwd_rows[bf16]),
        _row('bn_relu_pool_bwd', csrc + 'stem_pool.cu',
             'odtk_tpu/ops/pallas/stem_kernel.py:157',
             train_launches['stem_bwd'], dict(bwd_rows[bf16], max_abs_err=max(
                 r['max_abs_err'] for r in bwd_rows.values()))),
        _row('det_loss', csrc + 'det_loss.cu',
             'odtk_tpu/ops/pallas/focal_kernel.py:186',
             train_launches['det_loss'], loss_row),
    ]
    print(f'e2e_ms_per_batch: {batch_ms}')
    print(f'train_ms_per_step: {step_ms}')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
