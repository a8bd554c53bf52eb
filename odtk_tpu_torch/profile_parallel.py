"""Data parallel across the cards of one host, against world 1.

    python3 -m odtk_tpu_torch.profile_parallel [--json FILE]

World N is every card of the host (N >= 2, else it fails). On 128
synthetic 480x640 JPEGs with random boxes (``profile_train``'s data; an
epoch of several batches a rank, since each epoch starts the loader
anew) and
ResNet50FPN at its published widths (80 classes, random weights from a
seed), bf16, resize 800 / max 1333, 8 images a card, after building the
kernels:

1. ``train``: the CLI (``python -m odtk_tpu_torch.main train``; one host
   spawning a process a card) for 10 steps of a global batch of 8N at
   lr 0.001: every process exits 0, every rank says its world, the
   logged losses are finite;
2. ``infer``: the CLI on that checkpoint at world N (a global batch of
   2N) and at world 1 (batch 2, the first card alone): the detection
   JSONs equal;
3. ``engine``: a bf16 engine exported at world 1, then ``infer`` on it
   as in 2 (each rank moves the program to its own card): equal;
4. ``step``: ``train()`` for 24 steps at world N (N spawned ranks, a
   global batch of 8N) and at world 1 (batch 8, the first card): the
   median ms a step after the first 4, between the steps' CUDA events
   (``train``'s ``step_ms``), on each rank and at world 1;
5. ``all_reduce``: N spawned ranks each sum a buffer of ResNet50FPN's
   gradient bytes (the parameters' fp32 gradients and the two losses:
   151,662,296 bytes) with ``parallel.all_reduce_sum``, the train
   step's one collective: ms a call between CUDA events (median of 20
   on each rank) and NCCL's device time a call (``torch.profiler``, 5
   calls after a barrier; a rank's kernel also waits for the ranks that
   reach the collective later, so the least of the ranks' is the
   transfer's).

It prints the cards' names and power limits and, last, one JSON object.
"""

import argparse
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile

import torch

from .profile_infer import write_images
from .profile_train import AUGMENT, write_annotations

IMAGES = 128
STEPS = 10
TIMED_STEPS, WARM_STEPS = 24, 4
GRAD_BYTES = 151_662_296          # ResNet50FPN, 80 classes: 37,915,572 x 4 + 8
RUNS = 20


def _free_master():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return f'127.0.0.1:{s.getsockname()[1]}'


def _cards():
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return '; '.join(out.stdout.strip().splitlines())


def _cli(argv, cwd, cards=None):
    """``odtk_tpu_torch.main`` in a process of its own; with ``cards``
    it sees only those. Returns its stdout; raises on a non-zero exit."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in [env.get('PYTHONPATH')] if p])
    if cards is not None:
        env['CUDA_VISIBLE_DEVICES'] = ','.join(map(str, cards))
    out = subprocess.run([sys.executable, '-m', 'odtk_tpu_torch.main',
                          '--master', _free_master()] + argv, cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    if out.returncode:
        raise RuntimeError(f'{" ".join(argv[:2])} exited {out.returncode}:\n'
                           f'{out.stderr[-4000:]}')
    return out.stdout


def _annotations(path):
    with open(path) as f:
        return json.load(f)['annotations']


def _step_ms(root, rank, world):
    """``train()`` for TIMED_STEPS steps of 8 images a card on card
    ``rank``: the median ms a step after the first WARM_STEPS."""
    from .model import Model
    from .train import train

    model = Model('ResNet50FPN', classes=80).initialize(0)
    result = train(
        model, {'path': os.path.join(root, f'step{rank}.pth')},
        os.path.join(root, 'images'), os.path.join(root, 'ann.json'), None,
        None, 800, 1333, [800, 800], 8 * world, TIMED_STEPS, 0, 0.001, 10,
        [TIMED_STEPS], 0.1, verbose=False, device=f'cuda:{rank}', **AUGMENT)
    return statistics.median(result['step_ms'][WARM_STEPS:])


def _step_rank(rank, world, master, root):
    """One rank of ``step``: writes its median ms to ``root``/step.rank."""
    import torch.distributed as dist

    from . import parallel

    parallel.init_distributed(master, 1, 0, 'cuda', rank, world)
    try:
        ms = _step_ms(root, rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f'step.{rank}'), 'w') as f:
        json.dump(ms, f)


def _all_reduce_rank(rank, world, master, root):
    """One rank of ``all_reduce``: writes its times to
    ``root``/all_reduce.rank."""
    import torch.distributed as dist

    from . import parallel

    parallel.init_distributed(master, 1, 0, 'cuda', rank, world)
    try:
        grads = [torch.full((GRAD_BYTES // 4,), rank + 1.0, device='cuda')]
        parallel.all_reduce_sum(grads)
        if not torch.all(grads[0] == world * (world + 1) / 2):
            raise AssertionError(f'rank {rank}: all-reduce sum wrong')
        times = []
        for i in range(3 + RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            parallel.all_reduce_sum(grads)
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            dist.barrier()
            torch.cuda.synchronize()
            for _ in range(5):
                parallel.all_reduce_sum(grads)
            torch.cuda.synchronize()
        # NCCL's kernels in order; the first is the barrier's
        nccl = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and 'nccl' in e.name.lower()),
                      key=lambda e: e.time_range.start)[1:]
        with open(os.path.join(root, f'all_reduce.{rank}'), 'w') as f:
            json.dump({'ms': statistics.median(times),
                       'nccl_ms': sum(e.time_range.elapsed_us()
                                      for e in nccl) / 1e3 / 5,
                       'nccl_kernels': len(nccl) / 5}, f)
    finally:
        dist.destroy_process_group()


def _spawned(fn, world, root, name):
    """``fn`` on every card, spawned; the ranks' results in rank order."""
    torch.multiprocessing.spawn(fn, args=(world, _free_master(), root),
                                nprocs=world)
    out = []
    for r in range(world):
        with open(os.path.join(root, f'{name}.{r}')) as f:
            out.append(json.load(f))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--json', type=str, default=None,
                        help='also write the results to this file')
    args = parser.parse_args(argv)
    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f'profile_parallel: {world} CUDA device(s); data '
                         'parallel needs 2 or more')
    from .ops.kernels import _build
    _build.build()
    smi = _cards()
    print(f'cards: {smi}', flush=True)
    result = {'cards': smi, 'world': world}
    with tempfile.TemporaryDirectory(prefix='odtk_parallel_') as root:
        img = os.path.join(root, 'images')
        write_images(img, IMAGES)
        ann = os.path.join(root, 'ann.json')
        write_annotations(ann, IMAGES)
        base = ['--images', img, '--annotations', ann, '--resize', '800',
                '--max-size', '1333']

        out = _cli(['train', 'r50.pth', '--classes', '80', '--batch',
                    str(8 * world), '--iters', str(STEPS), '--warmup', '10',
                    '--milestones', str(STEPS), '--lr', '0.001', '--jitter',
                    '800', '800', '--no-pretrained'] + base, root)
        (line,) = [ln for ln in out.splitlines()
                   if ln.startswith(f'[{STEPS}/{STEPS}]')]
        losses = [float(v) for v in re.findall(r'loss: ([^,]+),', line)]
        if len(losses) != 2 or not all(map(torch.isfinite,
                                           torch.tensor(losses))):
            raise AssertionError(f'train at world {world}: {line}')
        if out.count('world: ') != world:
            raise AssertionError(f'train: {out.count("world: ")} ranks '
                                 f'said their world, not {world}')
        result['train'] = {'losses': losses, 'global_batch': 8 * world,
                           'log': line}
        print(f'train: world {world}, global batch {8 * world}, {STEPS} '
              f'steps: {line}', flush=True)

        for label, model, flags in (
                ('infer', 'r50.pth', ['--threshold', '0.001']),
                ('engine', 'r50.engine', [])):
            if label == 'engine':
                _cli(['export', 'r50.pth', 'r50.engine', '--size', '800',
                      '1333', '--threshold', '0.001', '--dynamic-batch-opts',
                      '2', '2', '2'], root, cards=[0])
            _cli(['infer', model, '--batch', str(2 * world), '--output',
                  f'{label}_world.json'] + base + flags, root)
            _cli(['infer', model, '--batch', '2', '--output',
                  f'{label}_one.json'] + base + flags, root, cards=[0])
            got, want = (_annotations(os.path.join(root, f'{label}_{w}.json'))
                         for w in ('world', 'one'))
            if got != want or not got:
                raise AssertionError(f'{label}: world {world} gave '
                                     f'{len(got)} detections, world 1 '
                                     f'{len(want)}, not the same')
            result[label] = {'detections': len(got), 'equal': True}
            print(f'{label}: world {world} and world 1 give the same '
                  f'{len(got)} detections', flush=True)

        ranks = _spawned(_step_rank, world, root, 'step')
        one = _step_ms(root, 0, 1)
        result['step'] = {'world_ms': ranks, 'one_ms': one}
        print(f'step ({smi}): ms a step, median after {WARM_STEPS} of '
              f'{TIMED_STEPS}, 8 images a card: world {world} {ranks}, '
              f'world 1 {one}', flush=True)

        ranks = _spawned(_all_reduce_rank, world, root, 'all_reduce')
        result['all_reduce'] = {'bytes': GRAD_BYTES, 'ranks': ranks}
        print(f'all_reduce ({smi}): {GRAD_BYTES} bytes at world {world}: '
              f'{ranks}', flush=True)
    print(json.dumps(result))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
