"""The two loops that drive a measured window, and the set-up and the
checks around them.

``train``: the program's train step (``odtk_tpu_torch.train.
make_train_step``, the call ``train.py``'s loop makes) on a pool of
seeded batches in pinned host memory, each copied to the card on a side
stream one step ahead. Set-up drives the step through its
first three steps on three distinct batches and keeps what the check
needs; the same step then runs the window.

``serve``: a closed loop with one request in flight: a batch of u8
images copied from pinned host memory, ``Model.inference_fn_u8`` (the
call ``infer.py`` makes), the detections copied back to the host. A
request's latency runs from its submission to its detections in host
memory.

Each loop returns its end-to-end numbers, its window's trace context
(with ``--trace 1``) and the numbers that decide ``correct``.
"""

import collections
import gc
import math
import random
import time

import torch

from perfbench.lib import inputs, judge, weights
from perfbench.reference import retinanet as ref

LAG = 2     # steps between a stop decision and the step that reads it


def program_model(config, state, device):
    """The program's ``Model`` for ``config`` with ``state`` loaded, on
    ``device``, in the configuration's precision."""
    from odtk_tpu_torch.model import Model

    with torch.device('meta'):
        model = Model(config['backbone'], classes=config['classes'],
                      ratios=config['ratios'], scales=config['scales'],
                      anchor_ious=config['anchor_ious'],
                      config={k: config[k] for k in (
                          'threshold', 'top_n', 'nms', 'detections',
                          'fused_top_n')})
    model.module = model.module.to_empty(device=device)
    model.module.load_state_dict(state)
    model.to(device)
    model.set_dtype(torch.bfloat16 if config['precision'] == 'bf16'
                    else torch.float32)
    return model


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _norms(tensors):
    return [float(n) for n in torch.stack(
        torch._foreach_norm([t.float() for t in tensors])).double().cpu()]


def _fp32_reference():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_model(config, state, device, fp8=False):
    model = ref.RetinaNet(config['backbone'], config['classes'],
                          config['anchors']).to(device)
    model.load_state_dict(state)
    return ref.set_fp8(model, fp8)


class Phases:
    """Seconds of each set-up phase, the device synchronised at each mark."""

    def __init__(self, device):
        self.device, self.phases = device, []
        _sync(device)
        self.last = time.monotonic()

    def mark(self, name):
        _sync(self.device)
        now = time.monotonic()
        self.phases.append((name, now - self.last))
        self.last = now


class Feed:
    """Copies pool batches to the device on a side stream, one ahead."""

    def __init__(self, pool, device):
        self.pool, self.device = pool, device
        self.stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                       else None)

    def fetch(self, i):
        if self.stream is None:
            return dict(self.pool[i % len(self.pool)])
        with torch.cuda.stream(self.stream):
            return inputs.to_device(self.pool[i % len(self.pool)],
                                    self.device)

    def ready(self, batch):
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for t in batch.values():
                t.record_stream(current)
        return batch


class StopFlag:
    """Stops the window once the clock passes the deadline, keeping the
    host at most ``LAG`` steps ahead of the card: after each step the
    clock's decision goes into a device flag, copied to the host without
    a wait; before each step the flag of the step ``LAG`` back is read,
    which waits for that step only."""

    def __init__(self, device, deadline):
        self.device, self.deadline = device, deadline
        self.pending = collections.deque()

    def stop(self):
        if len(self.pending) < LAG:
            return False
        event, host = self.pending.popleft()
        if event is not None:
            event.synchronize()
        return bool(host.item() > 0)

    def mark(self):
        late = time.perf_counter() >= self.deadline
        flag = torch.full((1,), float(late), device=self.device)
        if self.device.type != 'cuda':
            self.pending.append((None, flag))
            return
        host = torch.empty(1, pin_memory=True)
        host.copy_(flag, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.pending.append((event, host))


# ------------------------------------------------------------------ training

def train_setup(config, mix, seed, device):
    """The program's train step with its model and optimizer, driven
    through its first three steps on pool batches 0-2; returns the state
    the window and the check need."""
    from odtk_tpu_torch import train as program_train

    clock = Phases(device)
    state = weights.state_dict(config, seed, device)
    model = program_model(config, state, device)
    optimizer = program_train.make_optimizer(
        model.module.parameters(), config['lr'], config['weight_decay'],
        config['momentum'])
    step = program_train.make_train_step(model, optimizer, 0.0, 'u8')
    clock.mark('weights and model')
    pool = inputs.train_pool(seed, mix, config['classes'], device)
    feed = Feed(pool, device)
    clock.mark('inputs')
    names = [n for n, _ in model.module.named_parameters()]
    params = [p for _, p in model.module.named_parameters()]
    losses, readings = [], {}
    nxt = feed.fetch(0)
    for i in range(3):
        cur, nxt = feed.ready(nxt), feed.fetch(i + 1)
        losses.append(step(config['lr'], cur['images'], cur['targets'],
                           cur['colors'], cur['sizes']))
        if i == 0:
            readings['grad_norms'] = _norms(
                [optimizer.state[p]['momentum_buffer'] for p in params])
    readings['update_norms'] = _norms(
        [p.detach() - state[n] for n, p in zip(names, params)])
    readings['losses'] = [(float(c), float(b)) for c, b in losses]
    clock.mark('first three steps')
    return {'model': model, 'optimizer': optimizer, 'step': step,
            'feed': feed, 'next': nxt, 'readings': readings,
            'state': state, 'pool': pool, 'names': names,
            'phases': clock.phases}


def train_window(run, config, seconds, device, spans):
    """Steps until the clock passes ``seconds``. Returns steps, elapsed s, the
    window's wall-clock ends (ns), skipped steps, the host ms of each
    step call and the pool index of each step."""
    step, feed, optimizer = run['step'], run['feed'], run['optimizer']
    lr, nxt = config['lr'], run['next']
    skipped = torch.zeros((), device=device)
    enqueue_ms, batches = [], []
    _sync(device)
    start_ns, t0 = time.time_ns(), time.perf_counter()
    flag = StopFlag(device, t0 + seconds)
    i = 3
    while True:
        with spans('stop_flag wait'):
            if flag.stop():
                break
        with spans('feed'):
            cur, nxt = feed.ready(nxt), feed.fetch(i + 1)
        with spans('step'):
            h0 = time.perf_counter()
            step(lr, cur['images'], cur['targets'], cur['colors'],
                 cur['sizes'])
            enqueue_ms.append(1e3 * (time.perf_counter() - h0))
        skipped += optimizer.found_inf
        batches.append(i % len(run['pool']))
        with spans('stop_flag mark'):
            flag.mark()
        i += 1
    _sync(device)
    elapsed = time.perf_counter() - t0
    run['next'] = nxt
    return {'steps': len(batches), 'elapsed': elapsed,
            'window_ns': (start_ns, time.time_ns()),
            'skipped': int(skipped), 'enqueue_ms': enqueue_ms,
            'batches': batches}


def reference_train(config, mix, seed, device, fp8=False, fault=None,
                    state=None):
    """The reference's readings for the first three steps, in fp32 or, as
    the control, fp8. ``fault``: 'half' leaves out half of each batch
    (the mean over the rest)."""
    _fp32_reference()
    state = state if state is not None else weights.state_dict(
        config, seed, device)
    model = reference_model(config, state, device, fp8)
    names = [n for n, _ in ref.trainable(model)]
    params = [p for _, p in ref.trainable(model)]
    p0 = [p.detach().clone() for p in params]
    bufs = [torch.zeros_like(p) for p in params]
    h, w = mix['canvas']
    levels = ref.Levels(h, w, config['ratios'], config['scales'], device)
    pool = inputs.train_pool(seed, mix, config['classes'], device)
    out = {'losses': []}
    for k in range(3):
        batch = {key: v.to(device) for key, v in pool[k].items()}
        if fault == 'half':
            batch = {key: v[:len(v) // 2] for key, v in batch.items()}

        def images(i, j, batch=batch):
            return ref.normalize_train(batch['images'][i:j],
                                       batch['colors'][i:j],
                                       batch['sizes'][i:j])

        cls_l, box_l, grads = ref.loss_and_grads(
            model, images, batch['targets'], levels, config['anchor_ious'],
            mix['reference_block'])
        if k == 0:
            out['grad_only'] = _norms(grads)
            out['grad_norms'] = _norms(
                [g + config['weight_decay'] * p for g, p in zip(grads, p0)])
        ref.sgd(params, grads, bufs, config['lr'], config['weight_decay'],
                config['momentum'])
        out['losses'].append((float(cls_l), float(box_l)))
        del grads
    out['update_norms'] = _norms([p.detach() - q for p, q in zip(params, p0)])
    out['names'] = names
    return out


# ------------------------------------------------------------------- serving

def serve_setup(config, mix, seed, device):
    clock = Phases(device)
    state = weights.state_dict(config, seed, device)
    model = program_model(config, state, device)
    clock.mark('weights and model')
    pool = inputs.eval_pool(seed, mix, device)
    clock.mark('inputs')
    for _ in range(mix['warmup_rounds']):
        for batch in pool:
            dev = inputs.to_device(batch, device)
            [t.cpu() for t in model.inference_fn_u8(dev['images'],
                                                    dev['sizes'])]
    clock.mark('warm-up requests')
    return {'model': model, 'pool': pool, 'state': state,
            'phases': clock.phases}


def serve_window(run, seconds, device, spans):
    """Requests until the clock passes ``seconds``. Returns the latency
    (s) of each request, elapsed s, the window's wall-clock ends (ns),
    the host ms of each call and the pool index and detections of each
    request."""
    model, pool = run['model'], run['pool']
    latency, enqueue_ms, served = [], [], []
    _sync(device)
    start_ns, t0 = time.time_ns(), time.perf_counter()
    end = t0 + seconds
    r = 0
    while time.perf_counter() < end:
        t_sub = time.perf_counter()
        with spans('h2d'):
            dev = inputs.to_device(pool[r % len(pool)], device)
        with spans('step'):
            out = model.inference_fn_u8(dev['images'], dev['sizes'])
            enqueue_ms.append(1e3 * (time.perf_counter() - t_sub))
        with spans('fetch'):
            dets = tuple(t.cpu() for t in out)
        latency.append(time.perf_counter() - t_sub)
        served.append((r % len(pool), dets))
        r += 1
    elapsed = time.perf_counter() - t0
    return {'latency': latency, 'elapsed': elapsed,
            'window_ns': (start_ns, time.time_ns()),
            'enqueue_ms': enqueue_ms, 'served': served}


def reference_detections(config, mix, state, batch, device, fp8=False):
    """The reference's candidates (logits [B, N, K], boxes [B, N, 4]) of
    one request batch, a block of images at a time, and each anchor's
    longer side [N]."""
    _fp32_reference()
    model = reference_model(config, state, device, fp8)
    h, w = mix['canvas']
    levels = ref.Levels(h, w, config['ratios'], config['scales'], device)
    images = batch['images'].to(device)
    sizes = batch['sizes'].to(device)
    logits, boxes = [], []
    block = mix['reference_block']
    with torch.no_grad():
        for i in range(0, len(images), block):
            x = ref.normalize_eval(images[i:i + block], sizes[i:i + block])
            lg, bx = ref.candidates(model(x), levels)
            logits.append(lg)
            boxes.append(bx)
    return torch.cat(logits), torch.cat(boxes), ref.anchor_sides(levels)


def serve_check(config, mix, seed, served, state, device):
    """The four detection numbers, worst over a sample of the served
    requests drawn from the seed (the last request always in it)."""
    rng = random.Random(seed)
    picks = sorted(set(rng.sample(range(len(served)),
                                  min(mix['check_requests'], len(served)))
                       + [len(served) - 1]))
    pool = inputs.eval_pool(seed, mix, device)
    numbers = {}
    by_batch = collections.defaultdict(list)
    for p in picks:
        by_batch[served[p][0]].append(served[p][1])
    for index, dets_list in sorted(by_batch.items()):
        logits, boxes, sides = reference_detections(config, mix, state,
                                                    pool[index], device)
        for dets in dets_list:
            got = judge.detection_numbers(dets, logits, boxes, sides, config)
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, 0.0), v)
        del logits, boxes
    return numbers, len(picks)


def free(run, device):
    """Drop the program's state before the reference runs."""
    run.clear()
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
