"""Where an exported engine's time goes on one CUDA device, beside the
checkpoint path's.

    python3 -m odtk_tpu_torch.profile_engine [--backbone NAME ...]
        [--json FILE]

ResNet50FPN (or the ``--backbone`` given; 80 classes, random weights
from a seeded generator), threshold 0.001, axis-aligned and rotated,
bf16 and fp32 (TF32 off), one engine per case exported at 896 x 1408
with one batch profile of 2. On one resident batch of normalized random
images it measures, for the engine call and for ``Model.inference_fn``
on the same batch: the mean host ms per call, synchronized
(``wall_ms``), and, from a ``torch.profiler`` trace of ``STEPS`` calls,
the device ms per call by kernel family (``profile_infer.family``). The
device time the engine spends above the checkpoint path's is what its
program adds on the card; the wall time above it, what it adds on the
host.
"""

import argparse
import json
import os
import time

import torch

from .profile_infer import add_backbone_arg, device_events, family

STEPS = 5
SIZE = (896, 1408)


def wall_ms(fn, runs=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / runs


def device_ms(fn, steps=STEPS):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_family = {}
    for e in device_events(prof):
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us()
    return {'device_ms': sum(by_family.values()) / 1e3 / steps,
            'by_family_ms': {k: v / 1e3 / steps for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', type=str, default=None,
                        help='also write the results to this file')
    add_backbone_arg(parser)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_engine: no CUDA device')
    from .export import export_model
    from .model import Model

    device = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = torch.randn(2, *SIZE, 3, generator=torch.Generator()
                         .manual_seed(0)).to(device)
    out = {'device': torch.cuda.get_device_name(0),
           'torch': torch.__version__, 'backbone': args.backbone,
           'size': list(SIZE), 'batch': 2, 'cases': {}}
    for rotated in (False, True):
        model = Model(args.backbone, classes=80, rotated_bbox=rotated,
                      config={'threshold': 0.001}).initialize(
            torch.Generator().manual_seed(0)).to(device)
        for precision, dtype in (('bf16', torch.bfloat16),
                                 ('fp32', torch.float32)):
            engine = export_model(model, SIZE, precision=precision,
                                  dynamic_batch_opts=[2])
            model.set_dtype(dtype)
            case = {}
            for name, fn in (('engine', lambda: engine(images)),
                             ('checkpoint', lambda: model.inference_fn(
                                 images))):
                case[name] = {'wall_ms': wall_ms(fn), **device_ms(fn)}
            key = f'{"rotated" if rotated else "axis"}_{precision}'
            out['cases'][key] = case
            print(f'{key}: wall ms/call engine '
                  f'{case["engine"]["wall_ms"]:.3f}, checkpoint '
                  f'{case["checkpoint"]["wall_ms"]:.3f}; device ms/call '
                  f'engine {case["engine"]["device_ms"]:.3f}, checkpoint '
                  f'{case["checkpoint"]["device_ms"]:.3f}', flush=True)
            for name in case:
                top = list(case[name]['by_family_ms'].items())[:4]
                print(f'  {name:10s} ' + ', '.join(
                    f'{k} {v:.3f}' for k, v in top), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
