"""What a traced window says: the device's busy and idle time, device time
by kernel family and by kernel, and the longest idle gaps with what the
host was doing in each.

The window is traced with ``torch.profiler`` collecting CUDA activity
only (kernels, copies, the CUDA runtime calls), which adds little to the
host's time a step; the benchmark's own host spans (``Spans``) and the
window's ends are taken on the wall clock, the profiler's own time base.
Device time counts every kernel, memcpy and memset once. ``FAMILIES``
is a copy of ``odtk_tpu_torch/profile_infer.py``'s table.
"""

import re
import time

FAMILIES = [
    ('nms kernel', ('nms_kernel', 'nms_axis_mask', 'nms_count_kernel<4>',
                    'nms_order_kernel<4>', 'nms_scan_kernel<4>')),
    ('rotated nms kernel', ('nms_rotated_kernel', 'nms_count', 'nms_order',
                            'nms_mask', 'nms_scan')),
    ('rotated matcher kernel', ('match_kernel', 'match_levels_kernel')),
    ('stem backward kernel', ('stem_pool_bwd',)),
    ('stem argmax forward kernel', (
        'stem_pool_idx', 'stem_pool_fwd_kernel<__nv_bfloat16, true>',
        'stem_pool_fwd_kernel<float, true>')),
    ('stem kernel', ('stem_pool',)),
    ('det_loss kernel', ('det_loss',)),
    ('optimizer (fused SGD)', ('fused_sgd', 'multi_tensor', 'sgd_')),
    ('conv layout transform', ('nchwtonhwc', 'nhwctonchw',
                               'tensortransform')),
    ('depthwise conv', ('depthwise',)),
    ('conv / GEMM math', ('xmma', 'cutlass', 'nvjet', 'gemm', 'cudnn',
                          'fprop', 'convolve', 'fft')),
    ('topk / sort', ('topk', 'sort', 'radix')),
    ('memcpy / memset', ('memcpy', 'memset')),
]


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'elementwise'


def short(name, width=96):
    """A kernel's name without its return type, arguments and namespaces."""
    name = name.replace('(anonymous namespace)::', '').removeprefix('void ')
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == '<') - (ch == '>')
        if ch == '(' and depth == 0:
            name = name[:i]
            break
    return re.sub(r'\b[A-Za-z_]\w*::', '', name)[:width]


class Spans:
    """The benchmark's host spans on the wall clock (ns), when on."""

    def __init__(self, on):
        self.on, self.spans = on, []

    def __call__(self, name):
        return _Span(self, name) if self.on else _NOSPAN


class _Span:
    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.start = time.time_ns()

    def __exit__(self, *exc):
        self.owner.spans.append((self.name, self.start, time.time_ns()))
        return False


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOSPAN = _NoSpan()


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """The device events (name, start us, end us) of a profile cut to the
    window [start_ns, end_ns] of the wall clock, and the host's CUDA
    runtime calls and benchmark spans."""

    def __init__(self, prof, start_ns, end_ns, spans=()):
        from torch.autograd import DeviceType

        origin = prof.profiler.kineto_results.trace_start_ns()
        lo, hi = (start_ns - origin) / 1e3, (end_ns - origin) / 1e3
        self.window = (lo, hi)
        device, host = [], []
        for e in prof.events():
            if getattr(e, 'is_user_annotation', False):
                continue
            start, end = e.time_range.start, e.time_range.end
            if end <= lo or start >= hi:
                continue
            if e.device_type == DeviceType.CUDA:
                device.append((e.name, max(start, lo), min(end, hi)))
            else:
                host.append((e.name, start, end))
        host += [(name, (s - origin) / 1e3, (e - origin) / 1e3)
                 for name, s, e in spans]
        self.device, self.host = device, host
        self.busy = _union([(s, e) for _, s, e in device])

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy) / 1e6

    def family_s(self):
        out = {}
        for name, s, e in self.device:
            fam = family(name)
            out[fam] = out.get(fam, 0.0) + (e - s) / 1e6
        return out

    def matching_s(self, *fragments):
        """Device seconds of the events whose name holds a fragment."""
        return sum(e - s for n, s, e in self.device
                   if any(f in n for f in fragments)) / 1e6

    def top_ops(self, n=10):
        out = {}
        for name, s, e in self.device:
            out[short(name)] = out.get(short(name), 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The ``n`` longest idle stretches of the device, each named by
        the host events running when it began (outermost first)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            inner = sorted((h for h in self.host if h[1] <= s < h[2]),
                           key=lambda h: h[1])
            name = ' > '.join(h[0] for h in inner) or 'host: python'
            out.append([f'{name} @ {(s - lo) / 1e3:.3f} ms', (e - s) / 1e6])
        return out
