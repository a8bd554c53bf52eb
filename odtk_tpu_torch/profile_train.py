"""Where the training step's time goes on one CUDA device.

    python3 -m odtk_tpu_torch.profile_train [--rotated] [--backbone NAME ...]
        [--json FILE]

The path and sizes of ``chip_smoke.py``'s train phase: ResNet50FPN (or
the ``--backbone`` given; 80 classes, random weights from a seeded
generator), bf16 compute on fp32 parameters, batch 8, the u8 feed,
resize 800 / max 1333 on 32 synthetic 480x640 JPEGs (an 896x1152 canvas)
with random ground-truth boxes, SGD at a constant lr of 0.001. With
``--rotated``, its rotated-train phase: the rotated-box model (27
anchors, a box head of 6 x 27), up to 24 rotated boxes an image,
gradients clipped to a global norm of 25. It measures, in this order:

1. ``loader``: the training loader alone (``DataIterator``, u8, the
   CLI's default colour augmentation), ms per batch over two epochs,
   host clock;
2. ``device_path``: the train step on one resident batch (colour affine,
   forward, assignment, loss, backward, gradient norm, SGD): the median
   ms per step between CUDA events, the median host time to enqueue one
   step, and, from a ``torch.profiler`` trace of 5 steps, the device
   time per step by kernel family (``profile_infer.FAMILIES``) and by
   kernel of the package's own CUDA kernels, and for each of those its
   launches' device ms and the device event that ran just before each
   with its ms (a copy there may be a layout change of its input); and
   the layout of the cotangent that the step hands the stem's backward;
3. ``train``: the ``train`` loop, unprofiled, for 24 steps: its median
   ms per step after the first 4 (the loop's own step intervals), and
   the device's idle share there, estimated as 1 - (device ms per step
   from 2) / (ms per step).

Device time counts every kernel, memcpy and memset once, as in
``profile_infer``.
"""

import argparse
import json
import os
import random
import statistics
import tempfile
import time

import numpy as np
import torch

from .profile_infer import (_short, add_backbone_arg, device_breakdown,
                            device_events, family, write_images)

IMAGES = 32
BATCH = 8
STEPS = 5
TRAIN_STEPS = 24
LR = 0.001
ROTATED_MAX_BOXES = 24
ROTATED_CLIP_GRADS = 25.0     # chip_smoke.py's rotated-train clip
# the CLI's defaults
AUGMENT = dict(augment_brightness=0.002, augment_contrast=0.002,
               augment_hue=0.0002, augment_saturation=0.002)


def write_annotations(path, n, classes=80, seed=0, rotated=False):
    """COCO ground truth for the n 480x640 images of ``write_images``:
    1-6 random boxes each, or 1-24 rotated ones ([x, y, w, h, theta],
    theta within pi/6) (their pixels are not drawn: the run times the
    step, and the step's work does not depend on where the boxes are)."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        images.append({'id': i, 'file_name': f'{i:06d}.jpg', 'width': 640,
                       'height': 480})
        for _ in range(rng.randint(1, ROTATED_MAX_BOXES + 1 if rotated
                                   else 7)):
            w, h = rng.randint(24, 300), rng.randint(24, 240)
            x, y = rng.randint(0, 640 - w), rng.randint(0, 480 - h)
            bbox = [int(x), int(y), int(w), int(h)]
            if rotated:
                bbox.append(float(rng.uniform(-np.pi / 6, np.pi / 6)))
            anns.append({'id': len(anns) + 1, 'image_id': i,
                         'category_id': int(rng.randint(1, classes + 1)),
                         'bbox': bbox, 'area': int(w * h), 'iscrowd': 0})
    cats = [{'id': c + 1, 'name': f'class{c}'} for c in range(classes)]
    with open(path, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': cats}, f)
    return path


def _loader(img_dir, ann, stride, rotated):
    from .data import DataIterator, RotatedDataIterator

    cls = RotatedDataIterator if rotated else DataIterator
    return cls(img_dir, [800, 800], 1333, BATCH, stride, 1, ann,
               training=True, emit='u8', **AUGMENT)


def loader_phase(img_dir, ann, stride, rotated):
    it = _loader(img_dir, ann, stride, rotated)
    t0 = time.perf_counter()
    batches = [b for _ in range(2) for b in it]
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    return batches[0], {'ms_per_batch': ms, 'batches': len(batches)}


def device_phase(model, batch, device, clip_grads):
    from torch.profiler import ProfilerActivity, profile

    from .train import make_optimizer, make_train_step

    tensors = [torch.from_numpy(a).to(device) for a in batch]
    optimizer = make_optimizer(model.module.parameters(), LR)
    step = make_train_step(model, optimizer, clip_grads, feed='u8')

    def run():
        return step(LR, *tensors)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    step_ms, enqueue_ms = [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        run()
        enqueue_ms.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            run()
        torch.cuda.synchronize()
    by_family, by_kernel = device_breakdown(prof, STEPS)
    return {
        'step_ms_median': statistics.median(step_ms),
        'enqueue_ms_median': statistics.median(enqueue_ms),
        'device_ms_per_step': sum(by_family.values()),
        'by_family_ms_per_step': by_family,
        'by_kernel_ms_per_step': by_kernel,
        'own_launches': own_launches(prof),
        'stem_cotangent': stem_cotangent(run),
    }


def own_launches(prof):
    """{kernel: {'ms': [device ms of each launch], 'after': {name of the
    device event just before it: count}, 'after_ms': [that event's device
    ms]}} for the package's own kernels (the families whose name ends in
    'kernel'), in the trace's order."""
    events = sorted(device_events(prof), key=lambda e: e.time_range.start)
    out = {}
    for before, e in zip([None] + events[:-1], events):
        if not family(e.name).endswith('kernel'):
            continue
        row = out.setdefault(_short(e.name),
                             {'ms': [], 'after': {}, 'after_ms': []})
        row['ms'].append(e.time_range.elapsed_us() / 1e3)
        if before is not None:
            name = _short(before.name)
            row['after'][name] = row['after'].get(name, 0) + 1
            row['after_ms'].append(before.time_range.elapsed_us() / 1e3)
    return out


def stem_cotangent(run):
    """[{shape, stride, dtype, contiguous}] of each cotangent that one
    call of run hands the stem's backward (its wrapper wrapped for the
    call)."""
    from .ops.kernels import stem

    seen, real = [], stem.bn_relu_pool_bwd

    def spy(idx, g, scale, conv_hw):
        seen.append({'shape': list(g.shape), 'stride': list(g.stride()),
                     'dtype': str(g.dtype), 'contiguous': g.is_contiguous()})
        return real(idx, g, scale, conv_hw)

    spy.launches = real.launches
    stem.bn_relu_pool_bwd = spy
    try:
        run()
        torch.cuda.synchronize()
    finally:
        stem.bn_relu_pool_bwd = real
        real.launches = spy.launches
    return seen


def train_phase(model, img_dir, ann, ckpt, device, clip_grads):
    from .train import train

    result = train(model, {'path': ckpt}, img_dir, ann, img_dir, None, 800,
                   1333, [800, 800], BATCH, TRAIN_STEPS, 0, LR, 0, [], 0.1,
                   verbose=False, device=device, clip_grads=clip_grads,
                   rotated_bbox=model.rotated_bbox, **AUGMENT)
    return {'ms_per_step_median': statistics.median(result['step_ms'][4:]),
            'steps': len(result['step_ms'])}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', type=str, default=None,
                        help='also write the results to this file')
    add_backbone_arg(parser)
    parser.add_argument('--rotated', action='store_true',
                        help='the rotated-box model and targets')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: no CUDA device')
    from .model import Model

    device = torch.device('cuda', 0)
    random.seed(0)
    model = Model(args.backbone, classes=80,
                  rotated_bbox=args.rotated).initialize(
        torch.Generator().manual_seed(0))
    clip = ROTATED_CLIP_GRADS if args.rotated else 0.0
    model.to(device)
    model.set_dtype(torch.bfloat16)

    out = {'device': torch.cuda.get_device_name(0),
           'torch': torch.__version__, 'backbone': args.backbone,
           'images': IMAGES, 'batch': BATCH, 'steps': STEPS,
           'rotated': args.rotated}
    with tempfile.TemporaryDirectory(prefix='odtk_profile_') as root:
        img_dir = write_images(os.path.join(root, 'images'), IMAGES)
        ann = write_annotations(os.path.join(root, 'train.json'), IMAGES,
                                rotated=args.rotated)
        batch, out['loader'] = loader_phase(img_dir, ann, model.stride,
                                            args.rotated)
        out['device_path'] = device_phase(model, batch, device, clip)
        out['train'] = train_phase(model, img_dir, ann,
                                   os.path.join(root, 'model.pth'), device,
                                   clip)
    out['train']['device_idle_share_est'] = 1 - (
        out['device_path']['device_ms_per_step']
        / out['train']['ms_per_step_median'])

    dp = out['device_path']
    print(f'loader alone: {out["loader"]["ms_per_batch"]:.3f} ms/batch '
          f'(b={BATCH})')
    print(f'train step: {dp["step_ms_median"]:.3f} ms/step (events), '
          f'enqueue {dp["enqueue_ms_median"]:.3f} ms, device busy '
          f'{dp["device_ms_per_step"]:.3f} ms/step')
    for k, v in dp['by_family_ms_per_step'].items():
        print(f'  {k:24s} {v:8.3f} ms/step '
              f'{100 * v / dp["device_ms_per_step"]:5.1f}%')
    for k, v in dp['by_kernel_ms_per_step'].items():
        print(f'    {k:32s} {v:8.4f} ms/step')
    for k, v in dp['own_launches'].items():
        print(f'    {k}: launches ' + ', '.join(f'{ms:.4f}' for ms in v['ms'])
              + f' ms; after {v["after"]}, '
              + ', '.join(f'{ms:.4f}' for ms in v['after_ms']) + ' ms')
    print(f'  stem backward cotangent: {dp["stem_cotangent"]}')
    print(f'train loop: {out["train"]["ms_per_step_median"]:.3f} ms/step, '
          f'device idle share (est.) '
          f'{100 * out["train"]["device_idle_share_est"]:.1f}%')
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
