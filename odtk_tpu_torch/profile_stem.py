"""The stem's three kernels alone on one CUDA device: event and device time.

    python3 -m odtk_tpu_torch.profile_stem [--json FILE]

Times each stem kernel (``ops/kernels/stem.py``) at the shapes of the main
paths, on seeded random inputs, bf16 and fp32:

- ``bn_relu_pool`` (the primal forward) at [2, 64, 448, 576] (the
  checkpoint path's b=2 conv1 output) and [2, 64, 448, 704] (the
  engines');
- ``bn_relu_pool_idx`` (the forward with argmax) and ``bn_relu_pool_bwd``
  (the routing backward) at [8, 64, 448, 576] (the train batch).

For each: the median of 20 CUDA-event-timed calls (the host's enqueue
included), the device time per call from a ``torch.profiler`` trace of 20
calls (the sum of the trace's device-side events over the calls), and
the byte bound (inputs read once, outputs written once, at 3.35 TB/s).
It checks nothing: ``chip_smoke.py`` and ``tests/test_torch_kernels.py``
hold the kernels to their plain versions. Its output names only the
kernels' wrappers, so it runs on an older tree of the package too.
"""

import argparse
import json
import os
import statistics

import torch

RUNS = 20
HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM device memory, bytes / ms
INFER_SHAPE = (2, 64, 448, 576)
ENGINE_SHAPE = (2, 64, 448, 704)
TRAIN_SHAPE = (8, 64, 448, 576)


def _inputs(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    scale = (torch.rand(shape[1], generator=g) + 0.5).to(device)
    shift = torch.randn(shape[1], generator=g).to(device)
    y = torch.randn(shape, generator=g).to(device, dtype)
    return y, scale, shift


def _pooled(shape):
    b, c, hc, wc = shape
    return b * c * ((hc - 1) // 2 + 1) * ((wc - 1) // 2 + 1)


def _event_ms(fn):
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn):
    """(device ms per call, the kernels' names) from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_infer import _short, device_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    us = sum(e.time_range.elapsed_us() for e in events)
    return us / 1e3 / RUNS, sorted({_short(e.name) for e in events})


def measure(name, fn, nbytes):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    event = _event_ms(fn)
    device, kernels = _device_ms(fn)
    bound = nbytes / HBM_BYTES_PER_MS
    row = {'event_ms': event, 'device_ms': device, 'bound_ms': bound,
           'device_share_of_bound': bound / device, 'kernels': kernels}
    print(f'{name}: event {event:.4f} ms, device {device:.4f} ms, bound '
          f'{bound:.4f} ms ({100 * bound / device:.0f}% of the bound), '
          f'{kernels}', flush=True)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', type=str, default=None,
                        help='also write the results to this file')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_stem: no CUDA device')
    from .ops.kernels import stem

    device = torch.device('cuda', 0)
    out = {'device': torch.cuda.get_device_name(0),
           'torch': torch.__version__, 'runs': RUNS, 'rows': {}}
    for dtype in (torch.bfloat16, torch.float32):
        s = torch.tensor([], dtype=dtype).element_size()
        kind = str(dtype)[6:]
        for shape in (INFER_SHAPE, ENGINE_SHAPE):
            y, scale, shift = _inputs(shape, dtype, device, 1)
            out['rows'][f'row 2 {kind} {list(shape)}'] = measure(
                f'row 2 {kind} {list(shape)}',
                lambda: stem.bn_relu_pool(y, scale, shift),
                (y.numel() + _pooled(shape)) * s)
        y, scale, shift = _inputs(TRAIN_SHAPE, dtype, device, 2)
        pooled = _pooled(TRAIN_SHAPE)
        out['rows'][f'row 3 {kind} {list(TRAIN_SHAPE)}'] = measure(
            f'row 3 {kind} {list(TRAIN_SHAPE)}',
            lambda: stem.bn_relu_pool_idx(y, scale, shift),
            y.numel() * s + pooled * (s + 1))
        _, idx = stem.bn_relu_pool_idx(y, scale, shift)
        g = torch.randn(idx.shape, generator=torch.Generator().manual_seed(3))
        g = g.to(device, dtype)
        out['rows'][f'row 4 {kind} {list(TRAIN_SHAPE)}'] = measure(
            f'row 4 {kind} {list(TRAIN_SHAPE)}',
            lambda: stem.bn_relu_pool_bwd(idx, g, scale, TRAIN_SHAPE[2:]),
            y.numel() * s + pooled * (s + 1))
        del y, idx, g
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
