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

The backward is also timed launch by launch (min / median / max device
ms over 20 calls) three ways: into a freshly allocated ``dy`` each call
(every output kept, the allocator's cache emptied first), into one
``dy`` reused (through the C entry point ``odtk_stem_pool_bwd``), and
right after the forward with argmax that made its codes. Beside it, as a
yardstick, ``aten.max_pool2d_with_indices_backward`` at the same shape,
on int64 indices made from the codes outside the timed region (a
sentinel window routes to its centre): it routes without the BN scale
and reads 8-byte indices, so it computes only part of the backward's
function. The port never calls it. And the write alone: ``dy.zero_()``
launch by launch, the floor of a kernel that writes ``dy`` at this card's
write rate.

It checks nothing: ``chip_smoke.py`` and
``tests/test_torch_kernels.py`` hold the kernels to their plain versions.
Its output names only the kernels' wrappers and the C entry point, so it
runs on an older tree of the package too.
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _trace(fn):
    from torch.profiler import ProfilerActivity, profile

    from .profile_infer import device_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    return device_events(prof)


def _device_ms(fn):
    """(device ms per call, the kernels' names) from a profiler trace."""
    from .profile_infer import _short

    events = _trace(fn)
    us = sum(e.time_range.elapsed_us() for e in events)
    return us / 1e3 / RUNS, sorted({_short(e.name) for e in events})


def _launch_spread(fn, key):
    """{min, median, max, launches}: the device ms of each launch of the
    kernels whose name holds ``key`` over RUNS calls of fn."""
    ms = [e.time_range.elapsed_us() / 1e3 for e in _trace(fn)
          if key in e.name]
    return {'min': min(ms), 'median': statistics.median(ms), 'max': max(ms),
            'launches': len(ms)}


def _show(name, s):
    print(f'  {name}: device {s["min"]:.4f} / {s["median"]:.4f} / '
          f'{s["max"]:.4f} ms (min / median / max of {s["launches"]} '
          'launches)', flush=True)


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


def _bwd_into(lib, idx, g, scale, dy):
    """The backward through the C entry point, into the given dy."""
    from .ops.kernels import _build

    b, c, hc, wc = dy.shape
    rc = lib.odtk_stem_pool_bwd(
        idx.data_ptr(), g.data_ptr(), scale.data_ptr(), dy.data_ptr(),
        _DTYPES[dy.dtype], b, c, hc, wc, *idx.shape[2:],
        _build.stream_handle(dy.device))
    _build.check(rc, 'odtk_stem_pool_bwd')


def _aten_indices(idx, wc):
    """max_pool2d's flat int64 indices from the codes (sentinel: the
    window's centre, which always lies in the map)."""
    hp, wp = idx.shape[2:]
    code = torch.where(idx == 9, 4, idx.long())
    p = torch.arange(hp, device=idx.device)[:, None]
    q = torch.arange(wp, device=idx.device)[None, :]
    return (2 * p - 1 + code // 3) * wc + (2 * q - 1 + code % 3)


def backward_spread(y, scale, shift, idx, g):
    """Row 4 launch by launch: dy fresh, dy reused, right after the
    forward with argmax; and the aten routing yardstick."""
    from .ops.kernels import _build, stem

    lib = _build.library()
    hw = tuple(y.shape[2:])
    out = {}
    fresh = []

    def fresh_call():
        fresh.append(stem.bn_relu_pool_bwd(idx, g, scale, hw))

    fresh_call()
    torch.cuda.synchronize()
    fresh.clear()
    torch.cuda.empty_cache()
    out['dy_fresh'] = _launch_spread(fresh_call, 'stem_pool_bwd')
    fresh.clear()
    torch.cuda.empty_cache()
    dy = torch.empty_like(y)
    _bwd_into(lib, idx, g, scale, dy)
    out['dy_reused'] = _launch_spread(
        lambda: _bwd_into(lib, idx, g, scale, dy), 'stem_pool_bwd')

    def after_forward():
        _, codes = stem.bn_relu_pool_idx(y, scale, shift)
        stem.bn_relu_pool_bwd(codes, g, scale, hw)

    after_forward()
    out['after_forward'] = _launch_spread(after_forward, 'stem_pool_bwd')
    ind = _aten_indices(idx, y.shape[3])

    def aten():
        torch.ops.aten.max_pool2d_with_indices_backward(
            g, dy, [3, 3], [2, 2], [1, 1], [1, 1], False, ind)

    aten()
    torch.cuda.synchronize()
    device, kernels = _device_ms(aten)
    out['aten_routing'] = {'event_ms': _event_ms(aten), 'device_ms': device,
                           'kernels': kernels}
    dy.zero_()
    out['dy_fill'] = _launch_spread(dy.zero_, '')
    for k in ('dy_fresh', 'dy_reused', 'after_forward', 'dy_fill'):
        _show(k, out[k])
    a = out['aten_routing']
    print(f'  aten max_pool2d_with_indices_backward: event '
          f'{a["event_ms"]:.4f} ms, device {a["device_ms"]:.4f} ms, '
          f'{kernels}', flush=True)
    return out


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
        key = f'row 4 {kind} {list(TRAIN_SHAPE)}'
        out['rows'][key] = measure(
            key, lambda: stem.bn_relu_pool_bwd(idx, g, scale, TRAIN_SHAPE[2:]),
            y.numel() * s + pooled * (s + 1))
        out['rows'][key].update(backward_spread(y, scale, shift, idx, g))
        del y, idx, g
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
