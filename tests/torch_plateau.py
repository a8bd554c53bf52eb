#!/usr/bin/env python3
"""The train-to-AP oracle's axis training in both packages from one init,
on the CPU: where each leaves the early plateau.

    python3 tests/torch_plateau.py [--size full|quick] [--seeds 0 1]
        [--iters 1600] [--init CKPT] [--cpus 4] [--workdir DIR]
        [--json FILE]

For each seed the port draws a ResNet18FPN init (``Model.initialize``)
and writes it as a ``.ckpt`` at iteration 0, which both packages read
(one msgpack layout). A copy each is then trained side by side, each
CLI pinned to ``--cpus`` cores of its own: ``python -m odtk_tpu.main
train`` and ``python -m odtk_tpu_torch.main train --device cpu``, with
``odtk_tpu_torch.validate_synthetic``'s recipe (its data, 3 classes,
b=8, lr 0.004, warmup 300, a 0.1 decay at 3/4 of ``--iters``; ``quick``:
its small images and sizes), in fp32 on the u8 feed in both, fresh
momentum in both. Each CLI's ``infer`` then scores its checkpoint as the
oracle's ``axis_ckpt`` leg does. ``--init`` starts both from a trained
``.ckpt`` instead (its weights, iteration and momentum; the milestone
stays at 3/4 of ``--iters``): two runs from one state on the plateau.

Per package and seed it reports the mean focal and box loss of each 100
iterations (the trainers' ``ODTK_DEBUG`` lines), the first 100
iterations whose mean focal loss is under 0.5 (where the run has left the
plateau of background-only predictions; None if it never does), and the
AP@[.5:.95], or the iteration at which the trainer stopped on a
non-finite loss ("Loss is diverging!", both packages' rule). Only the
init is shared: each package's loader draws its own batches and
augmentation.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from odtk_tpu_torch import validate_synthetic as oracle  # noqa: E402
from odtk_tpu_torch.model import Model  # noqa: E402

# (module, flags of every call, flags of a train call)
PACKAGES = {'jax': ('odtk_tpu.main', [], ['--feed', 'u8']),
            'torch': ('odtk_tpu_torch.main', ['--device', 'cpu'], [])}


def run(package, args, cpus, log):
    """One CLI call of ``package`` on the cores ``cpus``, its output
    appended to ``log``; returns its stdout, raises on failure, returns
    None where a ``train`` stopped on a non-finite loss."""
    module, every, train = PACKAGES[package]
    env = dict(os.environ, ODTK_DEBUG='1', JAX_PLATFORMS='cpu',
               ODTK_CACHE_DIR=os.path.join(REPO, '.jax_cache'),
               OMP_NUM_THREADS=str(len(cpus)), PYTHONPATH=REPO)
    cmd = (['taskset', '-c', ','.join(map(str, cpus)), sys.executable, '-m',
            module] + [str(a) for a in args] + ['--full-precision'] + every
           + (train if args[0] == 'train' else []))
    p = subprocess.run(cmd, cwd=os.path.dirname(log), env=env,
                       capture_output=True, text=True)
    with open(log, 'a') as f:
        f.write(' '.join(cmd) + '\n' + p.stdout + p.stderr)
    if p.returncode and 'Loss is diverging!' in p.stderr:
        return None
    if p.returncode:
        raise RuntimeError(f'{package} {args[0]} failed rc={p.returncode}: '
                           f'{p.stderr[-2000:]}')
    return p.stdout


def one(package, init, seed, img, ann, sizes, iters, cpus, work, report):
    """Train and score ``package``'s copy of ``init``."""
    _, _, res, mx, _ = sizes
    mile = max(1, int(iters * 0.75))
    root = os.path.join(work, f'{package}{seed}')
    os.makedirs(root, exist_ok=True)
    ckpt = os.path.join(root, 'axis.ckpt')
    shutil.copy(init, ckpt)
    log = os.path.join(root, 'log.txt')
    flags = [str(a) for a in oracle.train_args(iters, res, mx, mile)
             if a not in ('--override', '--no-pretrained')]
    t0 = time.time()
    stdout = run(package, ['train', ckpt, '--backbone', 'ResNet18FPN',
                           '--images', img, '--annotations', ann] + flags,
                 cpus, log)
    seconds = time.time() - t0
    if stdout is None:
        with open(log) as f:
            text = f.read()
        diverged = int(re.findall(r'Loss is diverging! \(iteration (\d+)',
                                  text)[-1])
        record, stats = oracle.training(text, init), None
    else:
        diverged = None
        record = oracle.training(stdout, ckpt)
        stats = oracle.parse_stats(run(
            package, ['infer', ckpt, '--images', img, '--annotations', ann,
                      '--batch', 8, '--resize', res, '--max-size', mx],
            cpus, log))
    record.pop('applied')
    means = [focal for focal, _ in record['loss_per_100']]
    report[f'{package}{seed}'] = dict(
        record, package=package, seed=seed, train_seconds=round(seconds, 1),
        leaves_plateau=next((i * 100 for i, m in enumerate(means)
                             if m < 0.5), None),
        diverged_at=diverged, ap=None if stats is None else stats['ap'])
    print(json.dumps(report[f'{package}{seed}']), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--size', choices=['full', 'quick'], default='full')
    ap.add_argument('--seeds', type=int, nargs='+', default=[0])
    ap.add_argument('--iters', type=int, default=1600)
    ap.add_argument('--init', default=None,
                    help='a .ckpt both packages resume from')
    ap.add_argument('--cpus', type=int, default=4,
                    help='cores for each package\'s CLI')
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--json', default=None, help='write the report here')
    args = ap.parse_args(argv)
    work = os.path.abspath(args.workdir or tempfile.mkdtemp(
        prefix='odtk_plateau_'))
    os.makedirs(work, exist_ok=True)
    sizes = oracle.FULL if args.size == 'full' else oracle.QUICK
    img, ann = oracle.make_data(work, sizes[0], sizes[1])
    report = {}
    for seed in args.seeds:
        init = args.init or os.path.join(work, f'init{seed}.ckpt')
        if not args.init:
            Model('ResNet18FPN', classes=3).initialize(seed).save(
                {'path': init, 'iteration': 0})
        threads = [threading.Thread(target=one, args=(
            package, init, seed, img, ann, sizes, args.iters,
            range(i * args.cpus, (i + 1) * args.cpus), work, report))
            for i, package in enumerate(PACKAGES)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if len(report) < 2 * (args.seeds.index(seed) + 1):
            raise SystemExit('a training failed: see the logs in ' + work)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump({'size': args.size, 'iters': args.iters,
                       'runs': report}, f, indent=1)
    return report


if __name__ == '__main__':
    main()
