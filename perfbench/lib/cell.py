"""One cell of ``BENCHMARK.json``, resolved to its files and run.

Nothing here names a configuration, a traffic mix or a metric: a cell's
configuration is ``configs/<config>.json``, its mix
``traffic/<traffic>.json`` (whose ``loop`` is ``train`` or ``serve``),
its correctness limits ``limits/<workload>.json``, and each per-layer
metric is read by ``metrics/<metric>.py``'s ``read(ctx)``, which returns
a number or ``None`` where it finds nothing to read.
"""

import importlib.util
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

from perfbench.lib.trace import Spans, Trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'odtk_tpu')


def _load(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _load(os.path.join(ROOT, 'BENCHMARK.json'))


def resolve(name):
    """The cell ``name`` with its config, mix, limits and metric lists."""
    bench = benchmark()
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r}; have {sorted(cells)}')
    cell = dict(cells[name])
    configs = {c['name']: c for c in bench['configs']}
    cell['config_file'] = os.path.join(ROOT, configs[cell['config']]['file'])
    cell['config_data'] = _load(cell['config_file'])
    cell['mix'] = _load(os.path.join(HERE, 'traffic',
                                     cell['traffic'] + '.json'))
    cell['limits'] = _load(os.path.join(HERE, 'limits', name + '.json'))
    cell['end_to_end'] = [m for m in bench['end_to_end']
                          if name in m.get('workloads', cells)]
    reported = {m['name'] for m in cell['end_to_end']}
    cell['per_layer'] = [
        m for m in bench['per_layer']
        if name in m.get('workloads', cells) and m['moves'] in reported]
    return cell


def reader(metric):
    path = os.path.join(HERE, 'metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + metric.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ a run

def run(cell, seed, seconds, trace, device, started):
    """One run of ``cell`` on ``device``; returns the result dict.
    ``started``: time.monotonic() at the start of the run's process."""
    import torch

    from perfbench.lib import loops

    device = torch.device(device)
    config, mix = cell['config_data'], cell['mix']
    window_s = min(seconds, mix['trace_seconds']) if trace else seconds
    loop = mix['loop']
    spans = Spans(trace)
    out = {'e2e': {}, 'log': []}
    if loop == 'train':
        state = loops.train_setup(config, mix, seed, device)
        setup_s = time.monotonic() - started
        with _profiler(trace, device) as prof:
            win = loops.train_window(state, config, window_s, device, spans)
        steps = win['steps']
        out['e2e']['train_images_per_s'] = (
            steps * mix['batch'] / win['elapsed'])
        out['attempted'], out['failed'] = steps, win['skipped']
        out['log'].append(f'train: {steps} steps of {mix["batch"]} images '
                          f'in {win["elapsed"]:.3f} s, '
                          f'{win["skipped"]} skipped')
        program = state['readings']
        names = state['names']
        fg = (_fg_anchors(config, mix, state['pool'], device)
              if trace else None)
    else:
        state = loops.serve_setup(config, mix, seed, device)
        setup_s = time.monotonic() - started
        with _profiler(trace, device) as prof:
            win = loops.serve_window(state, window_s, device, spans)
        latency, served = win['latency'], win['served']
        n = len(latency)
        out['e2e']['infer_images_per_s'] = n * mix['batch'] / win['elapsed']
        out['e2e']['infer_latency_p95_ms'] = 1e3 * loops.percentile(
            latency, 95)
        out['attempted'], out['failed'] = n, 0
        out['log'].append(
            f'infer latency: median {1e3 * statistics.median(latency):.3f} '
            f'ms, p95 {out["e2e"]["infer_latency_p95_ms"]:.3f} ms over {n} '
            f'requests of {mix["batch"]} images in {win["elapsed"]:.3f} s')
    out['e2e']['setup_s'] = setup_s
    ready = setup_s - sum(t for _, t in state['phases'])
    out['log'].append('setup: ' + ', '.join(
        f'{name} {t:.3f} s' for name, t in
        [('start, imports, card', ready)] + state['phases']))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)

    ctx = None
    if trace:
        tr = Trace(prof, *win['window_ns'], spans.spans)
        ctx = _context(cell, tr, win['enqueue_ms'], device)
        if loop == 'train':
            ctx.fg_anchors = [fg[b] for b in win['batches']]
        else:
            ctx.rounds = [int((d[0] > 0).sum(1).max()) for _, d in served]
        del prof

    check_state = state.pop('state')
    loops.free(state, device)
    if loop == 'train':
        numbers = _train_check(config, mix, seed, device, program, names,
                               check_state)
    else:
        numbers, sampled = loops.serve_check(config, mix, seed, served,
                                             check_state, device)
        out['log'].append(f'checked {sampled} of {len(served)} requests')
    out['numbers'] = numbers
    out['peak'] = peak
    out['modules'] = forbidden_modules()
    if trace:
        out['busy'] = (ctx.trace.busy_s, ctx.trace.window_s)
        out['per_layer'] = {}
        for m in cell['per_layer']:
            value = reader(m['name'])(ctx)
            if value is not None:
                out['per_layer'][m['name']] = value
        out['breakdown'] = {'device_ops': ctx.trace.top_ops(),
                            'idle_gaps': ctx.trace.idle_gaps()}
    return out


def _profiler(trace, device):
    """A profiler of the device's activity (the host's own only on the
    CPU, which has no device), or nothing."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    if not trace:
        return contextlib.nullcontext()
    return profile(activities=[ProfilerActivity.CUDA if device.type == 'cuda'
                               else ProfilerActivity.CPU])


def _fg_anchors(config, mix, pool, device):
    """Foreground anchors of each pool batch, by the reference's
    assignment (the loss kernel reads the box tensors there)."""
    from perfbench.reference import retinanet as ref

    h, w = mix['canvas']
    levels = ref.Levels(h, w, config['ratios'], config['scales'], device)
    out = []
    for batch in pool:
        assigned = ref.targets_of(levels, batch['targets'].to(device),
                                  config['anchor_ious'])
        out.append(int(sum((d > 0).sum() for _, _, d in assigned)))
    return out


def _context(cell, tr, enqueue, device):
    from perfbench.lib import counts
    from perfbench.reference import retinanet as ref

    import torch

    config, mix = cell['config_data'], cell['mix']
    h, w = mix['canvas']
    b = mix['batch']
    cells = sum((h // s) * (w // s) for s in (8, 16, 32, 64, 128))
    with torch.device('meta'):
        module = ref.RetinaNet(config['backbone'], config['classes'],
                               config['anchors'])
    return SimpleNamespace(
        kind=mix['loop'], trace=tr, steps=len(enqueue), enqueue_ms=enqueue,
        batch=b, canvas=(h, w),
        itemsize=2 if config['precision'] == 'bf16' else 4,
        conv1_shape=(b, 64, (h + 1) // 2, (w + 1) // 2),
        anchors=b * cells * config['anchors'],
        logits=b * cells * config['anchors'] * config['classes'],
        levels=5, candidates=config['fused_top_n'],
        detections=config['detections'],
        image_macs=counts.conv_macs(module, (3, h, w)),
        device=device)


def _train_check(config, mix, seed, device, program, names, state):
    from perfbench.lib import judge, loops

    reference = loops.reference_train(config, mix, seed, device, state=state)
    if reference['names'] != names:
        raise RuntimeError('the reference and the program name their '
                           'parameters differently')
    return judge.train_numbers(program, reference)
