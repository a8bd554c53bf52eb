"""The w8a8 convolution (``odtk::conv_w8a8``) over one forward of a w8a8
model, call class by call class, on one CUDA device.

    python3 -m odtk_tpu_torch.profile_w8a8 [--json FILE]
    python3 -m odtk_tpu_torch.profile_w8a8 --sweep [--json FILE]

ResNet50FPN (80 classes, random weights from seed 0) at bf16, its
convolutions swapped to w8a8 (``quantize.build_quant_variables``) by an
absmax table captured on one batch of seeded random images, b=2 at
896 x 1408. It captures the 111 conv calls of one forward (forward hooks)
and reports:

- by call class (``call_class``: conv1; layer1-4 1x1 / 3x3 / downsample;
  the FPN laterals, smooths, P6, P7; the heads by level): the calls, the
  kernels' device ms over one pass of the class's calls (torch.profiler,
  ``RUNS`` passes) split by kernel into the quantize pass, the GEMM and
  the split-K finish, the class's bound (per call the larger of bytes
  over 3.35 TB/s and int8 operations over 1979 TOP/s), bf16 cuDNN
  ``F.conv2d`` on the same shapes (dequantized weights), and, for the
  1x1 stride-1 calls, cuBLASLt's int8 GEMM (``torch._int_mm``) on the
  quantized activations: the yardsticks, which the port never calls;
- the host us a call: the 111 calls enqueued with no synchronisation,
  host clock, median of 5 passes;
- the w8a8 model's and its bf16 engine's (``export.export_model``) wall
  ms a batch, synchronized, on resident batches.

``--sweep`` measures instead the evidence behind ``conv_w8a8.plan``'s cost
model: at calls of that forward (``SWEEP_SHAPES``, seeded random
inputs), the device ms of the GEMM and of the finish pass under every N
tile and split of K into up to 4 slices, each run's output held equal to
the plan's own, beside ``plan_cost``'s rating; and ``nvcc -Xptxas -v``'s
report on ``csrc/conv_w8a8.cu`` with the seconds of its compile and of
the library's build.

Otherwise it checks nothing (``chip_smoke.py`` holds every call to the
plain version). It names only the wrapper, and sorts device events by name
fragments that both designs of ``csrc/conv_w8a8.cu`` share (the first,
``mma.sync`` one and the ``wgmma`` one), so a copy runs on an older
tree.
"""

import argparse
import bisect
import json
import math
import statistics
import time

import torch

RUNS = 5
GAP_S = 0.002      # host idle at the start of each profiled class
SIZE = (896, 1408)
BATCH = 2
HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM device memory, bytes / ms
INT8_OPS_PER_MS = 1979e12 / 1e3     # H100 SXM int8 tensor cores, dense

# the order of the table: a ResNet FPN forward's classes
CLASSES = (['conv1'] + [f'layer{i} {k}' for i in range(1, 5)
                        for k in ('1x1', '3x3', 'downsample')]
           + ['fpn lateral', 'fpn smooth', 'P6', 'P7']
           + [f'head P{i}' for i in range(3, 8)])


def call_class(name, x, image_height):
    """The class of a conv call from its module's name (and, for a head
    conv, its level from the input's height): 'other' for a name of
    another backbone."""
    leaf = name.rsplit('.', 1)[-1]
    if name.startswith(('cls_head', 'box_head')):
        return f'head P{round(math.log2(image_height / x.shape[2]))}'
    if name.endswith('features.conv1'):
        return 'conv1'
    for i in range(1, 5):
        if f'.layer{i}.' in name:
            if '.downsample.' in name:
                return f'layer{i} downsample'
            return f'layer{i} {"3x3" if leaf == "conv2" else "1x1"}'
    for key, cls in (('lateral', 'fpn lateral'), ('smooth', 'fpn smooth'),
                     ('pyramid6', 'P6'), ('pyramid7', 'P7')):
        if leaf.startswith(key):
            return cls
    return 'other'


def kernel_part(kernel_name):
    """The part of the operator a device event belongs to."""
    name = kernel_name.lower()
    for key, part in (('quantize', 'quantize'), ('finish', 'finish'),
                      ('direct', 'direct')):
        if key in name:
            return part
    return 'gemm'


def conv_args(conv, x, out_dtype):
    return (x, conv.weight, conv.w_scale, conv.act_scale, conv.bias,
            conv.stride, conv.padding, conv.groups, out_dtype)


def conv_bound(conv, x, y):
    """(ms by bytes, ms by int8 operations) of one call: x read, the int8
    weight, scales and bias read, y written; 2 M N K operations."""
    o, kh, kw, _ = conv.weight.shape
    cin_g = x.shape[1] // conv.groups
    nbytes = (x.numel() * x.element_size() + o * kh * kw * cin_g + 8 * o
              + y.numel() * y.element_size())
    ops = 2.0 * y.numel() * kh * kw * cin_g
    return nbytes / HBM_BYTES_PER_MS, ops / INT8_OPS_PER_MS


def class_parts(groups, run, runs=RUNS):
    """{class: {part: device ms a pass}} of ``run(group)`` for each group
    of ``groups``, from one torch.profiler trace: class by class, ``runs``
    passes inside a ``record_function`` range that first idles the host
    for ``GAP_S`` and ends after a synchronize. A device event belongs to
    the last range that began more than GAP_S / 2 before it: the device's
    clock may sit apart from the host's by up to that. A first range runs
    every group once and is dropped: a trace can lose the events of its
    first moments (seen in a long process, where the first class read no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from .profile_infer import device_events

    label = 'w8a8 class '
    warm = ''                   # no class has an empty name
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label + warm):
            for group in groups.values():
                run(group)
            torch.cuda.synchronize()
        for cls, group in groups.items():
            with record_function(label + cls):
                time.sleep(GAP_S)
                for _ in range(runs):
                    run(group)
                torch.cuda.synchronize()
    # the ranges on the host; their annotations on the device span the
    # ranges' kernels and are no kernel
    starts = sorted((e.time_range.start + GAP_S * 1e6 / 2,
                     e.name[len(label):])
                    for e in prof.events() if e.name.startswith(label)
                    and e.device_type == DeviceType.CPU)
    out = {cls: {} for cls in [warm, *groups]}
    for e in device_events(prof):
        if e.name.startswith(label):
            continue
        i = max(bisect.bisect_right([t for t, _ in starts],
                                    e.time_range.start) - 1, 0)
        parts = out[starts[i][1]]
        part = kernel_part(e.name)
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us()
    del out[warm]
    if not any(out.values()):
        raise AssertionError('the profiler saw no device time')
    return {cls: {k: v / 1e3 / runs for k, v in parts.items()}
            for cls, parts in out.items()}


def _cudnn_args(conv, x):
    from .ops.kernels import conv_w8a8

    cin_g = x.shape[1] // conv.groups
    w = (conv_w8a8.unpack_weight(conv.weight, cin_g).float()
         * conv.w_scale[:, None, None, None]).to(torch.bfloat16)
    b = None if conv.bias is None else conv.bias.to(torch.bfloat16)
    return (x.to(torch.bfloat16), w.contiguous(), b, conv.stride,
            conv.padding, 1, conv.groups)


def _int_mm_args(conv, x):
    """(A [M, Cp] int8, B [Cp, N] int8 column-major) of a 1x1 stride-1
    call, or None for any other call."""
    from .ops.kernels import conv_w8a8

    o, kh, kw, cp = conv.weight.shape
    if ((kh, kw) != (1, 1) or tuple(conv.stride) != (1, 1)
            or tuple(conv.padding) != (0, 0) or conv.groups != 1):
        return None
    q = conv_w8a8.quantize_activations(x, conv.act_scale)
    a = torch.zeros(x.shape[0], x.shape[2], x.shape[3], cp,
                    dtype=torch.int8, device=x.device)
    a[..., :x.shape[1]] = q.permute(0, 2, 3, 1)
    return a.reshape(-1, cp), conv.weight.reshape(o, cp).t()


def class_table(calls, names, image_height):
    """Per call class, in ``CLASSES`` order: calls, the kernels' device
    ms by part, the bound, bf16 cuDNN's device ms; a 'total' row; and a
    '1x1 stride-1' row (not in the total) of the calls that _int_mm can
    compute, with its device ms beside the kernels'. ``calls`` are (conv,
    x, y) of one forward, ``names`` the convs' module names."""
    import torch.nn.functional as F

    from .ops.kernels import conv_w8a8

    groups = {}
    for conv, x, y in calls:
        cls = call_class(names[conv], x, image_height)
        groups.setdefault(cls, []).append((conv, x, y))
    order = [c for c in CLASSES if c in groups] + sorted(
        c for c in groups if c not in CLASSES)
    groups = {c: groups[c] for c in order}
    dense = [(conv, x, y) for conv, x, y in calls
             if _int_mm_args(conv, x) is not None]
    if dense:
        groups['1x1 stride-1'] = dense
    ours = class_parts(
        {c: [conv_args(conv, x, y.dtype) for conv, x, y in g]
         for c, g in groups.items()},
        lambda args: [conv_w8a8.conv_w8a8(*a) for a in args])
    cudnn = class_parts(
        {c: [_cudnn_args(conv, x) for conv, x, _ in g]
         for c, g in groups.items()},
        lambda args: [F.conv2d(*a) for a in args])
    int_mm = class_parts(
        {'1x1 stride-1': [_int_mm_args(conv, x) for conv, x, _ in dense]}
        if dense else {}, lambda args: [torch._int_mm(*a) for a in args])
    rows = {}
    for cls, group in groups.items():
        t_bytes = t_ops = 0.0
        for conv, x, y in group:
            b_ms, o_ms = conv_bound(conv, x, y)
            t_bytes += b_ms if b_ms >= o_ms else 0.0
            t_ops += o_ms if o_ms > b_ms else 0.0
        rows[cls] = dict(calls=len(group), ms=sum(ours[cls].values()),
                         parts=ours[cls], bound_ms=t_bytes + t_ops,
                         bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
                         cudnn_ms=sum(cudnn[cls].values()),
                         int_mm_ms=(sum(int_mm[cls].values())
                                    if cls in int_mm else None))
    total = dict(calls=len(calls), parts={}, int_mm_ms=None)
    summed = [r for c, r in rows.items() if c != '1x1 stride-1']
    for key in ('ms', 'bound_ms', 'bound_bytes_ms', 'bound_ops_ms',
                'cudnn_ms'):
        total[key] = sum(r[key] for r in summed)
    for r in summed:
        for k, v in r['parts'].items():
            total['parts'][k] = total['parts'].get(k, 0.0) + v
    rows['total'] = total
    return rows


def format_table(rows):
    """The class table as text lines."""
    lines = [f'{"class":<18}{"calls":>6}{"ms":>9}{"quantize":>10}'
             f'{"gemm":>9}{"finish":>9}{"bound":>9}{"by":>6}{"x bound":>9}'
             f'{"cuDNN":>9}{"_int_mm":>9}']
    for cls, r in rows.items():
        p = r['parts']
        by = 'bytes' if r['bound_bytes_ms'] >= r['bound_ops_ms'] else 'ops'
        mm = '' if r.get('int_mm_ms') is None else f'{r["int_mm_ms"]:.4f}'
        lines.append(
            f'{cls:<18}{r["calls"]:>6}{r["ms"]:>9.4f}'
            f'{p.get("quantize", 0.0):>10.4f}'
            f'{p.get("gemm", 0.0) + p.get("direct", 0.0):>9.4f}'
            f'{p.get("finish", 0.0):>9.4f}'
            f'{r["bound_ms"]:>9.4f}{by:>6}'
            f'{r["ms"] / r["bound_ms"]:>9.2f}{r["cudnn_ms"]:>9.4f}{mm:>9}')
    return lines


def host_us(args, passes=5):
    """Median host us a call of ``len(args)`` enqueues, no sync between."""
    from .ops.kernels import conv_w8a8

    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for a in args:
            conv_w8a8.conv_w8a8(*a)
        times.append((time.perf_counter() - start) * 1e6 / len(args))
        torch.cuda.synchronize()
    return statistics.median(times)


def batch_ms(fn, x, runs=10):
    """Median wall ms a call of ``fn(x)``, synchronized, after 2 warmups."""
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def capture_calls(model, fn):
    """Runs ``fn`` with a forward hook on every w8a8 convolution: [(conv,
    its input, its output)] of each call, in order, cloned."""
    from .backbones.layers import QuantConv2d

    calls = []

    def hook(module, args, out):
        calls.append((module, args[0].clone(), out.clone()))

    handles = [m.register_forward_hook(hook) for m in model.module.modules()
               if isinstance(m, QuantConv2d)]
    try:
        result = fn()
    finally:
        for h in handles:
            h.remove()
    return calls, result


def w8a8_model(device, seed=0):
    """(model, a batch): ResNet50FPN from ``seed`` at bf16, swapped to
    w8a8 by the absmax of one batch of seeded random images."""
    from .model import Model
    from .quantize import build_quant_variables, capture_activation_absmax

    model = Model('ResNet50FPN', classes=80).initialize(seed)
    model.to(device)
    model.set_dtype(torch.bfloat16)
    model.threshold = 0.001
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, *SIZE, 3, generator=g).to(device)
    table = capture_activation_absmax(model, x)
    build_quant_variables(model.module, table, mode='w8a8')
    return model, x


# b, c, h, w, N, kernel, stride, padding: calls of a ResNet50FPN forward
SWEEP_SHAPES = {
    'head P3 256': (2, 256, 112, 176, 256, 3, 1, 1),
    'head P3 720': (2, 256, 112, 176, 720, 3, 1, 1),
    'head P4 256': (2, 256, 56, 88, 256, 3, 1, 1),
    'head P5 256': (2, 256, 28, 44, 256, 3, 1, 1),
    'head P6 256': (2, 256, 14, 22, 256, 3, 1, 1),
    'layer1 1x1 64>256': (2, 64, 224, 352, 256, 1, 1, 0),
    'layer1 1x1 256>64': (2, 256, 224, 352, 64, 1, 1, 0),
    'layer3 1x1 1024>256': (2, 1024, 56, 88, 256, 1, 1, 0),
    'layer3 3x3': (2, 256, 56, 88, 256, 3, 1, 1),
    'conv1': (2, 3, 896, 1408, 64, 7, 2, 3),
}


def ptxas_report():
    """(nvcc's -Xptxas -v lines of conv_w8a8.cu, compile s, build s)."""
    import os
    import subprocess
    import tempfile

    from .ops.kernels import _build

    src = os.path.join(_build.CSRC, 'conv_w8a8.cu')
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas',
                               '-v', '-c', src, '-o',
                               os.path.join(tmp, 'conv.o')],
                              capture_output=True, text=True, check=True)
        compile_s = time.perf_counter() - start
    start = time.perf_counter()
    _build.build()
    lines = [line.strip() for line in done.stderr.splitlines()
             if 'registers' in line or 'spill' in line or 'entry' in line]
    return lines, compile_s, time.perf_counter() - start


def sweep(device, runs=10):
    """[{shape, bn, splits, units, gemm_ms, finish_ms, cost_us, plan}] of
    every N tile and K split (up to 4 slices) at the SWEEP_SHAPES calls;
    raises if a plan's output differs from the chosen plan's."""
    from .ops.kernels import conv_w8a8 as kconv

    chosen = kconv.plan
    g = torch.Generator().manual_seed(0)
    rows = []
    for name, (b, c, h, w, n, k, s, p) in SWEEP_SHAPES.items():
        x = (torch.randn(b, c, h, w, generator=g) * 2).to(device,
                                                         torch.bfloat16)
        wq = torch.randint(-127, 128, (n, c, k, k), generator=g,
                           dtype=torch.int8)
        args = (x, kconv.pack_weight(wq).to(device),
                (torch.rand(n, generator=g) * 0.01 + 1e-3).to(device),
                torch.tensor(0.02, device=device),
                torch.randn(n, generator=g).to(device), (s, s), (p, p), 1,
                torch.bfloat16)
        mine = chosen(b, c, h, w, n, k, k, s, s, p, p, 1)
        want = kconv.conv_w8a8(*args)
        widest = (kconv.TILE_N[-1] if mine.route == 'packed' else
                  min(t for t in kconv.TILE_N
                      if t >= min(n, kconv.TILE_N[0])))
        for bn in [t for t in kconv.TILE_N if t <= widest]:
            for splits in range(1, min(4, mine.k_tiles) + 1):
                k_per = -(-mine.k_tiles // splits)
                if -(-mine.k_tiles // k_per) != splits:
                    continue
                forced = mine._replace(
                    bn=bn, splits=splits, k_per=k_per, n_tiles=-(-n // bn),
                    ws_elems=splits * n * mine.m if splits > 1 else 0)
                kconv.plan = lambda *_, f=forced: f
                try:
                    got = kconv.conv_w8a8(*args)
                    parts = class_parts(
                        {name: [args]},
                        lambda al: [kconv.conv_w8a8(*a) for a in al],
                        runs)[name]
                finally:
                    kconv.plan = chosen
                if not torch.equal(got, want):
                    raise AssertionError(f'{name}: plan {forced} differs')
                rows.append(dict(
                    shape=name, bn=bn, splits=splits, units=forced.units,
                    gemm_ms=parts.get('gemm', 0.0),
                    finish_ms=parts.get('finish', 0.0),
                    cost_us=kconv.plan_cost(mine.m, n, mine.k_tiles, bn,
                                            k_per),
                    plan=(bn, splits) == (mine.bn, mine.splits)))
                r = rows[-1]
                print(f'{name:<20} N tile {bn:>3} splits {splits} units '
                      f'{r["units"]:>5} GEMM {r["gemm_ms"]:.4f} ms finish '
                      f'{r["finish_ms"]:.4f} ms modelled {r["cost_us"]:.1f} '
                      f'us' + ('  <- plan' if r['plan'] else ''), flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', default=None)
    parser.add_argument('--sweep', action='store_true',
                        help='the plan cost model\'s evidence and the '
                        'ptxas report, not the forward\'s table')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_w8a8: no CUDA device')
    device = torch.device('cuda', 0)
    if args.sweep:
        lines, compile_s, build_s = ptxas_report()
        print('\n'.join(lines), flush=True)
        print(f'conv_w8a8.cu compiled in {compile_s:.1f} s, the library '
              f'built in {build_s:.1f} s', flush=True)
        out = dict(device=torch.cuda.get_device_name(0), ptxas=lines,
                   compile_s=compile_s, build_s=build_s,
                   sweep=sweep(device))
        if args.json:
            with open(args.json, 'w') as f:
                json.dump(out, f, indent=1)
        return
    model, x = w8a8_model(device)
    with torch.no_grad():
        calls, _ = capture_calls(model, lambda: model.inference_fn(x))
        names = {m: n for n, m in model.module.named_modules()}
        rows = class_table(calls, names, SIZE[0])
        out = dict(device=torch.cuda.get_device_name(0), calls=len(calls),
                   classes=rows)
        for line in format_table(rows):
            print(line, flush=True)
        out['host_us_a_call'] = host_us(
            [conv_args(conv, c_x, y.dtype) for conv, c_x, y in calls])
        out['model_ms'] = batch_ms(model.inference_fn, x)
        from .export import export_model
        engine = export_model(model, SIZE, precision='bf16',
                              dynamic_batch_opts=[BATCH] * 3)
        out['engine_ms'] = batch_ms(engine, x)
    print(json.dumps({k: v for k, v in out.items() if k != 'classes'}),
          flush=True)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
