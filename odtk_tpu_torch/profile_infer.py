"""Where the inference path's time goes on one CUDA device.

    python3 -m odtk_tpu_torch.profile_infer [--json FILE]

The path and sizes of ``chip_smoke.py``'s end-to-end phase: ResNet50FPN
(80 classes, random weights from a seeded generator), bf16, batch 2,
threshold 0.001, on 32 synthetic 480x640 JPEGs resized to 800x1067 (an
896x1152 canvas). It measures, in this order:

1. ``loader``: the host loader alone (``DataIterator``), ms per batch
   over one epoch, host clock;
2. ``device_path``: the device path on one resident batch (normalize,
   backbone, heads, decode, NMS): the median ms per step between CUDA
   events, the median host time to enqueue one step, and, from a
   ``torch.profiler`` trace of 10 steps, the device time per
   step by kernel family and by kernel of the package's own CUDA
   kernels;
3. ``infer``: the ``infer`` loop over the images, unprofiled: its median
   ms per batch after the first (the loop's own batch intervals), and
   the device's idle share there, estimated as 1 - (device ms per step
   from 2) / (ms per batch).

Device time counts every kernel, memcpy and memset once: it sums the
trace's device-side events (``FunctionEvent.device_type`` CUDA). The
operator rows of ``key_averages()`` repeat their kernels' time, so a sum
over all its rows counts the device time twice.
"""

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch
from PIL import Image

IMAGES = 32
STEPS = 10

# lower-case kernel-name fragments -> family; the first match wins, the
# rest is 'elementwise' (batch-norm affine, ReLU, residual adds, bias,
# copies, cat, reductions); the training families serve profile_train
FAMILIES = [
    # the bitmask NMS kernels share their rank and scan, templates on the
    # box width: <4> axis-aligned, <6> rotated (csrc/nms_scan.cuh)
    ('nms kernel', ('nms_kernel', 'nms_axis_mask', 'nms_count_kernel<4>',
                    'nms_order_kernel<4>', 'nms_scan_kernel<4>')),
    ('rotated nms kernel', ('nms_rotated_kernel', 'nms_count', 'nms_order',
                            'nms_mask', 'nms_scan')),
    ('rotated matcher kernel', ('match_kernel', 'match_levels_kernel')),
    ('stem backward kernel', ('stem_pool_bwd',)),
    # row 3 apart from row 2: one template, <T, true> saves the argmax
    # (stem_pool_idx_kernel before the two were one template)
    ('stem argmax forward kernel', (
        'stem_pool_idx', 'stem_pool_fwd_kernel<__nv_bfloat16, true>',
        'stem_pool_fwd_kernel<float, true>')),
    ('stem kernel', ('stem_pool',)),
    ('det_loss kernel', ('det_loss',)),
    ('optimizer (fused SGD)', ('fused_sgd', 'multi_tensor', 'sgd_')),
    ('conv layout transform', ('nchwtonhwc', 'nhwctonchw',
                               'tensortransform')),
    ('conv / GEMM math', ('xmma', 'cutlass', 'nvjet', 'gemm', 'cudnn',
                          'fprop', 'convolve', 'fft')),
    ('topk / sort', ('topk', 'sort', 'radix')),
    ('memcpy / memset', ('memcpy', 'memset')),
]


def family(name):
    name = name.lower()
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return 'elementwise'


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _short(name):
    """A kernel's name without its namespace, return type and arguments."""
    name = name.replace('(anonymous namespace)::', '').split('(')[0]
    return name.rsplit('::', 1)[-1].removeprefix('void ')


def device_breakdown(prof, steps):
    """Device time per step (ms) of a profile: (by kernel family, by
    kernel of this package's own CUDA kernels, the families whose name
    ends in 'kernel'), each in decreasing order."""
    by_family, by_kernel = {}, {}
    for e in device_events(prof):
        fam = family(e.name)
        us = e.time_range.elapsed_us()
        by_family[fam] = by_family.get(fam, 0.0) + us
        if fam.endswith('kernel'):
            by_kernel[_short(e.name)] = by_kernel.get(_short(e.name), 0.0) + us
    return tuple({k: v / 1e3 / steps for k, v in
                  sorted(d.items(), key=lambda kv: -kv[1])}
                 for d in (by_family, by_kernel))


def write_images(root, n, seed=0):
    """n smooth random 480x640 JPEGs (upsampled noise)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        small = rng.randint(0, 256, (12, 16, 3), np.uint8)
        img = Image.fromarray(small).resize((640, 480), Image.BICUBIC)
        img.save(os.path.join(root, f'{i:06d}.jpg'), quality=90)
    return root


def loader_phase(img_dir, stride):
    from .data import DataIterator

    it = DataIterator(img_dir, 800, 1333, 2, stride, 1, None,
                      training=False, emit='u8')
    t0 = time.perf_counter()
    batches = [b for b in it]
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    return batches[0], {'ms_per_batch': ms, 'batches': len(batches)}


def device_phase(model, batch, steps, device):
    from torch.profiler import ProfilerActivity, profile

    data, _, _, sizes = batch
    u8 = torch.from_numpy(data).to(device)
    sizes = torch.from_numpy(sizes).to(device)

    def step():
        return model.inference_fn_u8(u8, sizes)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms, enqueue_ms = [], []
    for _ in range(30):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        step()
        enqueue_ms.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_family, by_kernel = device_breakdown(prof, steps)
    return {
        'step_ms_median': statistics.median(step_ms),
        'enqueue_ms_median': statistics.median(enqueue_ms),
        'device_ms_per_step': sum(by_family.values()),
        'by_family_ms_per_step': by_family,
        'by_kernel_ms_per_step': by_kernel,
    }


def infer_phase(model, img_dir, device):
    from .infer import infer

    result = infer(model, img_dir, None, 800, 1333, 2, verbose=False,
                   device=device)
    return {'ms_per_batch_median': statistics.median(result['batch_ms'][1:]),
            'batches': len(result['batch_ms'])}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', type=str, default=None,
                        help='also write the results to this file')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_infer: no CUDA device')
    from .model import Model

    device = torch.device('cuda', 0)
    model = Model('ResNet50FPN', classes=80).initialize(
        torch.Generator().manual_seed(0))
    model.threshold = 0.001
    model.to(device)
    model.set_dtype(torch.bfloat16)

    out = {'device': torch.cuda.get_device_name(0),
           'torch': torch.__version__, 'images': IMAGES, 'steps': STEPS}
    with tempfile.TemporaryDirectory(prefix='odtk_profile_') as root:
        img_dir = write_images(os.path.join(root, 'images'), IMAGES)
        batch, out['loader'] = loader_phase(img_dir, model.stride)
        out['device_path'] = device_phase(model, batch, STEPS, device)
        out['infer'] = infer_phase(model, img_dir, device)
    out['infer']['device_idle_share_est'] = 1 - (
        out['device_path']['device_ms_per_step']
        / out['infer']['ms_per_batch_median'])

    dp = out['device_path']
    print(f'loader alone: {out["loader"]["ms_per_batch"]:.3f} ms/batch')
    print(f'device path: {dp["step_ms_median"]:.3f} ms/step (events), '
          f'enqueue {dp["enqueue_ms_median"]:.3f} ms, device busy '
          f'{dp["device_ms_per_step"]:.3f} ms/step')
    for k, v in dp['by_family_ms_per_step'].items():
        print(f'  {k:24s} {v:8.3f} ms/step '
              f'{100 * v / dp["device_ms_per_step"]:5.1f}%')
    for k, v in dp['by_kernel_ms_per_step'].items():
        print(f'    {k:32s} {v:8.4f} ms/step')
    print(f'infer loop: {out["infer"]["ms_per_batch_median"]:.3f} ms/batch, '
          f'device idle share (est.) '
          f'{100 * out["infer"]["device_idle_share_est"]:.1f}%')
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
