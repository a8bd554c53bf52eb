"""Rows 6 and 8 of the kernel table alone on one CUDA device: event and
device time beside the bound.

    python3 -m odtk_tpu_torch.profile_kernels [--json FILE]

- Row 6, the focal sum of one level (``ops/kernels/focal.py``): its
  forward (``focal_sum_kernel``) and backward (``focal_sum_dx_kernel``)
  over the five levels of a b=8 train step on an 896 x 1152 canvas (H x W
  = 112 x 144, 56 x 72, 28 x 36, 14 x 18, 7 x 9), A = 9, K = 80, bf16
  and fp32. The heads are NHWC views of NCHW tensors, as the convolutions
  leave them, drawn about the -4.6 prior; the targets are seeded: 1%
  foreground with a random class, 2% ignored, the rest background. A
  call is the five levels, one launch of the wrapper each.
- Row 8, the unbatched rotated matcher (``rotated_best_match`` of
  ``ops/kernels/match_rotated.py``): the P3 level of one image (435,456
  rotated anchors, stride 8, 27 anchors a cell) against 128 target rows
  of which the first 7 are valid, rotated boxes drawn as
  ``tests/synth.py`` draws them (24-60 pixels a side on a 480 x 640
  image, +-30 degrees), scaled by 800 / 480 to the canvas. It prints the
  pairs each count of the work gives: every valid pair (what a clip of
  every pair costs), the pairs whose boxes overlap (the bound's count)
  and the pairs whose boxes widened by 0.25 meet (what an AABB skip
  clips).

For each: the median of 20 CUDA-event-timed calls (the host's enqueue
included), the device time per call from a ``torch.profiler`` trace of 20
calls (the sum of the trace's device-side events over the calls, the
wrapper's casts included, and that sum by kernel), and the bound: the
bytes (inputs read once, outputs written once) at 3.35 TB/s or, for row
8, the larger of that and 276 fp32 operations a clip over the
overlapping pairs at 67 TFLOP/s.

Then it counts row 6's inner loops in the built library (``cuobjdump
-sass``, the vector-path instances): the instructions of each loop that
holds 16-byte loads, per logit (a 16-byte load is 8 bf16 or 4 fp32
logits), and the issue floor they give the five levels: the logits times
that count over the card's issue rate (132 SMs x 4 schedulers x 32 lanes
a clock, at the SM clock ``nvidia-smi`` reports as the maximum).

It checks nothing: ``chip_smoke.py`` and ``tests/test_torch_kernels.py``
hold the kernels to their plain versions. It names only the kernels'
wrappers, so it runs on an older tree of the package too.
"""

import argparse
import json
import math
import os
import re
import subprocess

import numpy as np
import torch

from .profile_stem import RUNS, _event_ms

HBM_BYTES_PER_MS = 3.35e12 / 1e3     # H100 SXM device memory, bytes / ms
FP32_FLOPS_PER_MS = 67e12 / 1e3      # H100 SXM fp32 outside tensor cores
CLIP_OPS = 276                       # chip_smoke.py's CLIP_OPS
SKIP_MARGIN = 0.25                   # the matcher's AABB widening
BATCH, ANCHORS, CLASSES = 8, 9, 80
LEVELS = ((112, 144), (56, 72), (28, 36), (14, 18), (7, 9))
CANVAS = (1152, 896)                 # (width, height)
P3_STRIDE, ROWS, VALID_ROWS = 8, 128, 7


def focal_levels(dtype, device, seed=0):
    """[(head [B, H, W, A*K] NHWC view, cls_idx int32 [B, N], depth
    fp32 [B, N])] of the five levels."""
    rng = np.random.RandomState(seed)
    levels = []
    for h, w in LEVELS:
        n = h * w * ANCHORS
        head = torch.from_numpy(
            (rng.randn(BATCH, ANCHORS * CLASSES, h, w) * 1.5 - 4.6)
            .astype(np.float32)).to(device, dtype).permute(0, 2, 3, 1)
        u = rng.rand(BATCH, n)
        cls_idx = rng.randint(0, CLASSES, (BATCH, n)).astype(np.int32)
        depth = np.where(u < 0.01, cls_idx + 1.0,
                         np.where(u < 0.03, -1.0, 0.0)).astype(np.float32)
        levels.append((head, torch.from_numpy(cls_idx).to(device),
                       torch.from_numpy(depth).to(device)))
    return levels


def p3_match_case(device, seed=0):
    """(anchors [N, 8], clips [ROWS, 8], valid [ROWS]) of P3 of one
    image: the first VALID_ROWS rows valid, the rest -1 padding."""
    from .ops.anchors import generate_anchors_rotated
    from .ops.assign import rotated_level_anchors, rotated_targets

    # Model's defaults for a rotated model: 3 ratios x 3 scales x 3 angles
    table = generate_anchors_rotated(
        P3_STRIDE, (1.0, 2.0, 0.5), [4 * 2 ** (i / 3) for i in range(3)],
        (-math.pi / 6, 0, math.pi / 6))
    _, anchors = rotated_level_anchors(CANVAS, P3_STRIDE, table, device)
    rng = np.random.RandomState(seed)
    scale = 800 / 480
    targets = np.full((ROWS, 6), -1.0, np.float32)
    for i in range(VALID_ROWS):
        bw, bh = rng.randint(24, 60), rng.randint(24, 60)
        x, y = rng.randint(8, 640 - bw - 8), rng.randint(8, 480 - bh - 8)
        theta = rng.uniform(-np.pi / 6, np.pi / 6)
        targets[i] = (x * scale, y * scale, bw * scale, bh * scale, theta,
                      rng.randint(0, 3))
    _, valid, _, clips = rotated_targets(torch.from_numpy(targets)
                                         .to(device))
    return anchors, clips, valid


def match_pairs(anchors, clips, valid):
    """(every valid pair, the valid pairs whose boxes overlap, the valid
    pairs whose boxes widened by SKIP_MARGIN meet)."""
    q = anchors.reshape(-1, 4, 2)
    t = clips[valid].reshape(-1, 4, 2)
    lo, hi, tlo, thi = q.amin(1), q.amax(1), t.amin(1), t.amax(1)

    def meet(margin):
        return int(((lo[:, None] - margin <= thi[None] + margin)
                    & (hi[:, None] + margin >= tlo[None] - margin))
                   .all(-1).sum())
    return q.shape[0] * t.shape[0], meet(0.0), meet(SKIP_MARGIN)


def _device_ms(fn):
    """(device ms per call, {kernel: device ms per call}, device events per
    call) from a profiler trace of RUNS calls: the count shows a trace
    that dropped events."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_infer import _short, device_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    events = device_events(prof)
    for e in events:
        name = _short(e.name)
        kernels[name] = (kernels.get(name, 0.0)
                         + e.time_range.elapsed_us() / 1e3 / RUNS)
    return sum(kernels.values()), kernels, len(events) / RUNS


def measure(name, fn, nbytes, flops=0.0):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    event = _event_ms(fn)
    device, kernels, per_call = _device_ms(fn)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / FP32_FLOPS_PER_MS
    bound, by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops,
                                                            'operations')
    row = {'event_ms': event, 'device_ms': device, 'bound_ms': bound,
           'bound_by': by, 'device_share_of_bound': bound / device,
           'kernels': kernels, 'events_per_call': per_call}
    split = ', '.join(f'{k} {v:.4f}' for k, v in sorted(kernels.items()))
    print(f'{name}: event {event:.4f} ms, device {device:.4f} ms, bound '
          f'{bound:.4f} ms by {by} ({100 * bound / device:.0f}% of the '
          f'bound); {per_call:g} device events a call; device ms a call by '
          f'kernel: {split}', flush=True)
    return row


def focal_rows(device, out):
    from .ops.kernels import focal

    g = torch.tensor(0.37, device=device)
    for dtype in (torch.bfloat16, torch.float32):
        kind = str(dtype)[6:]
        levels = focal_levels(dtype, device)
        s = levels[0][0].element_size()
        logits = sum(x.numel() for x, _, _ in levels)
        targets = sum(c.numel() * 8 for _, c, _ in levels)
        out['rows'][f'row 6 forward {kind}'] = measure(
            f'row 6 forward {kind} (five levels)',
            lambda: [focal.focal_sum_kernel(x, c, d, CLASSES)
                     for x, c, d in levels],
            logits * s + targets + 4 * len(levels))
        out['rows'][f'row 6 backward {kind}'] = measure(
            f'row 6 backward {kind} (five levels)',
            lambda: [focal.focal_sum_dx_kernel(x, c, d, g, CLASSES)
                     for x, c, d in levels],
            2 * logits * s + targets + 4 * len(levels))
        out['rows'][f'row 6 backward {kind}']['logits'] = logits
        del levels


def match_row(device, out):
    from .ops.kernels import match_rotated

    anchors, clips, valid = p3_match_case(device)
    every, overlap, widened = match_pairs(anchors, clips, valid)
    n, m = anchors.shape[0], clips.shape[0]
    print(f'row 8 P3 [{n}] x {m} rows ({int(valid.sum())} valid): every '
          f'valid pair {every}, pairs whose boxes overlap {overlap}, '
          f'pairs whose boxes widened by {SKIP_MARGIN} meet {widened}',
          flush=True)
    row = measure(f'row 8 [{n}] x {m}',
                  lambda: match_rotated.rotated_best_match(anchors, clips,
                                                           valid),
                  n * 32 + m * 33 + n * 8, overlap * CLIP_OPS)
    row.update(every_valid_pair=every, overlapping_pairs=overlap,
               widened_pairs=widened,
               bound_every_pair_ms=every * CLIP_OPS / FP32_FLOPS_PER_MS)
    out['rows']['row 8'] = row


def _sass_functions(library):
    """{mangled name: [(address, instruction)]} of a library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [os.path.join(CUDA_HOME, 'bin', 'cuobjdump'), '-sass', library],
        check=True, capture_output=True, text=True).stdout
    functions, current = {}, None
    for line in text.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            current = functions.setdefault(head.group(1), [])
            continue
        ins = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);', line)
        if ins and current is not None:
            current.append((int(ins.group(1), 16), ins.group(2).strip()))
    return functions


def vector_loops(instructions):
    """Each loop (a backward branch's span) that holds 16-byte loads: its
    instruction count (NOPs left out) and its 16-byte loads."""
    loops = []
    for addr, ins in instructions:
        target = re.search(r'\bBRA\b.*?(0x[0-9a-f]+)', ins)
        if target and int(target.group(1), 16) < addr:
            body = [i for a, i in instructions
                    if int(target.group(1), 16) <= a <= addr
                    and not i.startswith('NOP')]
            loads = sum(1 for i in body if re.search(r'LDG\.E\.128', i))
            if loads:
                loops.append((len(body), loads))
    return loops


def sass_floor(out):
    from .ops.kernels import _build

    clock = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], check=True, capture_output=True,
        text=True).stdout.split()[0])
    rate = 132 * 4 * 32 * clock * 1e6 / 1e3        # thread instructions / ms
    for name, ins in sorted(_sass_functions(_build.build()).items()):
        kernel = re.search(r'(focal_sum(?:_dx)?_kernel)I(13__nv_bfloat16|f)'
                           r'Lb1ELb([01])E', name)
        if not kernel:          # the scalar path's instances
            continue
        kind = 'bfloat16' if kernel.group(2) != 'f' else 'float32'
        label = f'{kernel.group(1)} {kind} gamma ' + (
            '2' if kernel.group(3) == '1' else 'any')
        per_load = 8 if kind == 'bfloat16' else 4
        logits = out['rows'][f'row 6 backward {kind}']['logits']
        for size, loads in vector_loops(ins):
            per_logit = size / (loads * per_load)
            floor = logits * per_logit / rate
            print(f'{label}: a vector loop of {size} instructions and '
                  f'{loads} 16-byte loads, {per_logit:.2f} instructions a '
                  f'logit, issue floor {floor:.4f} ms for the five levels '
                  f'at {clock:.0f} MHz', flush=True)
            out.setdefault('sass', []).append(dict(
                kernel=label, instructions=size, loads=loads,
                per_logit=per_logit, floor_ms=floor, clock_mhz=clock))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', type=str, default=None,
                        help='also write the results to this file')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_kernels: no CUDA device')
    device = torch.device('cuda', 0)
    out = {'device': torch.cuda.get_device_name(0),
           'torch': torch.__version__, 'runs': RUNS, 'rows': {}}
    focal_rows(device, out)
    match_row(device, out)
    sass_floor(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
