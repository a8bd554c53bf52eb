#!/usr/bin/env python3
"""End-to-end synthetic accuracy validation (the train-to-AP oracle) of
the port, on the card by default.

    python3 -m odtk_tpu_torch.validate_synthetic [--out FILE]
        [--workdir DIR] [--legs LEG ...] [--device cuda|cpu] [--quick]
        [--iters 1600] [--rotated-iters 1600]

The port's copy of ``extras/validate_synthetic.py``, with its recipe
unchanged: it drives the CLI (``python -m odtk_tpu_torch.main``) on a
generated COCO-style set (``tests/synth.py:make_dataset``, 32 JPEGs of
320x400 with up to 3 boxes), trains ResNet18FPN from scratch (1600
iterations, b=8, lr 0.004, warmup 300, milestone 1200), evaluates the
checkpoint, a bf16 engine exported at 512 and the checkpoint at that
engine's letterbox geometry, INT8 engines calibrated with absmax, a
99.9 percentile and KL entropy, then fine-tunes a rotated model from
the axis checkpoint (``--clip-grads 25``) and evaluates its polygon AP.
Every call gets ``--device``. ``--quick``: 8 images of 160x200, 50
iterations, a plumbing check whose AP means nothing.

Seven legs, each recorded with the evaluator's 12 stats (none where the
CLI found no detections), the AP@[.5:.95] of each class and its wall
seconds: ``axis_ckpt``, ``axis_engine``, ``axis_ckpt_at_engine_scale``,
``int8_absmax``, ``int8_p999``, ``int8_entropy``, ``rotated_ckpt``. The
leg that ran a training also records it: the iterations, the updates
applied (the ``.ckpt``'s optax count, fewer where the non-finite step
skip fired) and the mean focal and box losses of each 100 iterations
(the trainer's ``ODTK_DEBUG`` lines), which show where a run leaves the
early plateau of background-only predictions.
``--legs`` runs a subset; a leg that needs the axis checkpoint trains it
first unless the workdir already holds one trained through ``--iters``.
Each finished leg is flushed to ``--out`` (default
``VALIDATION_TORCH.json`` at the repo root; ``VALIDATION.json`` is the
JAX package's record and is never written) with the card's name and
power limit (``"cpu"`` on the CPU). A rerun with the same ``--workdir``
and ``--out`` skips the legs recorded there and merges the new ones. The
CLI runs in the workdir, where ``infer`` writes its ``detections.json``.
Run-to-run spread: one ``--legs axis_ckpt`` call in each of N workdirs.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAT_NAMES = ['ap', 'ap50', 'ap75', 'ap_small', 'ap_medium', 'ap_large',
              'ar1', 'ar10', 'ar100', 'ar_small', 'ar_medium', 'ar_large']
LEGS = ('axis_ckpt', 'axis_engine', 'axis_ckpt_at_engine_scale',
        'int8_absmax', 'int8_p999', 'int8_entropy', 'rotated_ckpt')
INT8_LEGS = (('int8_absmax', []),
             ('int8_p999', ['--calibration-percentile', 99.9]),
             ('int8_entropy', ['--calibration-entropy']))


# (images, image size, resize, max size, engine size); the engine size
# must be stride-aligned (128): export rounds an unaligned size up, and
# the checkpoint leg at the engine's scale would then compare two scales
# (extras/validate_synthetic.py:103-110)
FULL = (32, (320, 400), 320, 448, 512)
QUICK = (8, (160, 200), 128, 256, 256)


def make_data(root, n_images, size, rotated=False):
    """The recipe's synthetic set (``tests/synth.py``, imported by path):
    up to 3 boxes an image, seed 11, or 12 for the rotated set."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from synth import make_dataset
    return make_dataset(root, n_images=n_images, size=size, max_boxes=3,
                        rotated=rotated, fmt='jpg', seed=12 if rotated else 11)


def train_args(iters, res, mx, mile):
    """The recipe's training flags after the data's: lr 0.004 with a 0.1
    decay at ``mile``, 3/4 of the axis training's iterations (5e-3 is the
    divergence edge from scratch, extras/validate_synthetic.py:122-124)."""
    return ['--iters', iters, '--classes', 3, '--batch', 8, '--resize', res,
            '--max-size', mx, '--jitter', res, res, '--lr', 0.004,
            '--warmup', 300, '--milestones', mile, '--val-iters', 0,
            '--override', '--max-det', 32, '--no-pretrained']


def run_cli(args, label, device, cwd):
    """``python -m odtk_tpu_torch.main ARGS --device DEVICE`` in ``cwd``
    (the repo root on its ``PYTHONPATH``; ``ODTK_DEBUG`` set for a
    ``train``, which then prints each iteration's losses): prints the last
    4000 characters of its output, raises on a non-zero exit, returns
    (stdout, wall seconds)."""
    args = [str(a) for a in args] + ['--device', device]
    cmd = [sys.executable, '-m', 'odtk_tpu_torch.main'] + args
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    if args[0] == 'train':
        env['ODTK_DEBUG'] = '1'
    print(f'==> [{label}] odtk-tpu-torch ' + ' '.join(args), flush=True)
    t0 = time.time()
    p = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True)
    sys.stdout.write(p.stdout[-4000:])
    if p.returncode:
        sys.stderr.write(p.stderr[-4000:])
        raise RuntimeError(f'{label} failed rc={p.returncode}')
    seconds = time.time() - t0
    print(f'<== [{label}] {seconds:.0f}s', flush=True)
    return p.stdout, seconds


def trained_through(ckpt, iters):
    """True if ckpt exists and its recorded iteration >= iters (safe to
    reuse: checkpoint writes are atomic); False for a file that does not
    read as a checkpoint."""
    if not os.path.isfile(ckpt):
        return False
    from .io.checkpoint import peek_iteration
    try:
        return peek_iteration(ckpt) >= iters
    except (OSError, ValueError):
        return False


def parse_stats(stdout):
    """The evaluator's 12 verbose lines (' AP@[.50:.95]   = 0.955', ...,
    ``data/coco_eval.py``) -> {name: value}, or None if fewer."""
    vals = re.findall(r'^\s+A[PR][ @].*=\s*([-\d.]+)\s*$', stdout, re.M)
    if len(vals) < 12:
        return None
    return {k: float(v) for k, v in zip(STAT_NAMES, vals[-12:])}


def training(stdout, ckpt):
    """A ``train`` call's record: its iterations, the updates applied (the
    optax count of the ``.ckpt``; None without an optimizer state) and the
    mean (focal, box) loss of each 100 iterations, from its ``ODTK_DEBUG``
    lines (``  debug it12: cl=1.0537 bl=0.4181 shape=...``)."""
    from .io import checkpoint
    from .io.msgpack import msgpack_restore

    losses = [(float(c), float(b)) for c, b in re.findall(
        r'^\s*debug it\d+: cl=(\S+) bl=(\S+)', stdout, re.M)]
    optimizer = checkpoint.read(ckpt).get('optimizer')
    counts = [] if not optimizer else [
        int(v['count']) for v in msgpack_restore(bytes(optimizer)).values()
        if isinstance(v, dict) and 'count' in v]
    groups = [losses[i:i + 100] for i in range(0, len(losses), 100)]
    return {'iterations': len(losses),
            'applied': counts[0] if counts else None,
            'loss_per_100': [[round(sum(x[k] for x in g) / len(g), 4)
                              for k in (0, 1)] for g in groups]}


def per_class_ap(ann, detections_file, iou_type):
    """AP@[.5:.95] of each category (all areas, 100 detections) of the
    detections an ``infer`` call wrote; -1 for a class without ground
    truth, None without the file."""
    from .data import CocoEvaluator, CocoIndex

    if not os.path.isfile(detections_file):
        return None
    with open(detections_file) as f:
        detections = json.load(f)['annotations']
    evaluator = CocoEvaluator(CocoIndex(ann), iou_type=iou_type)
    evaluator.evaluate(detections)
    p = evaluator.precision[:, :, :, 0, -1]
    return [round(float(p[:, :, k][p[:, :, k] > -1].mean()), 4)
            if (p[:, :, k] > -1).any() else -1.0 for k in range(p.shape[2])]


def card(device):
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not device.startswith('cuda'):
        return 'cpu'
    index = device.partition(':')[2] or '0'
    out = subprocess.run(
        ['nvidia-smi', '-i', index, '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out',
                    default=os.path.join(ROOT, 'VALIDATION_TORCH.json'))
    ap.add_argument('--iters', type=int, default=1600)
    ap.add_argument('--rotated-iters', type=int, default=1600)
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--legs', nargs='+', choices=LEGS, default=list(LEGS),
                    help='the legs to run (default all seven)')
    ap.add_argument('--device', default='cuda',
                    help='passed to every CLI call (default cuda)')
    ap.add_argument('--quick', action='store_true',
                    help='50 iters, tiny images: plumbing check only')
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, 'VALIDATION.json'):
        ap.error('VALIDATION.json is the JAX package\'s record')
    return args


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    work = os.path.abspath(args.workdir or tempfile.mkdtemp(
        prefix='odtk_torch_validate_'))
    os.makedirs(work, exist_ok=True)
    # resumable: each finished leg is flushed to --out at once; a rerun
    # with the same --workdir skips the legs recorded there
    done = {}
    if args.workdir and os.path.isfile(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if prev.get('workdir') == work:
            done = {k: prev[k] for k in LEGS if prev.get(k)}
    if args.quick:
        args.iters, args.rotated_iters = 50, 50
    n_im, size, res, mx, esize = QUICK if args.quick else FULL
    img, ann = make_data(work, n_im, size)
    rimg, rann = make_data(os.path.join(work, 'rot'), n_im, size,
                           rotated=True)

    mile = max(1, int(args.iters * 0.75))
    out = {'recipe': {'backbone': 'ResNet18FPN', 'iters': args.iters,
                      'lr': 0.004, 'warmup': 300, 'milestones': [mile],
                      'batch': 8, 'resize': res, 'images': n_im,
                      'rotated_iters': args.rotated_iters},
           'workdir': work, 'device': card(args.device)}
    out.update(done)

    def flush():
        out['total_seconds'] = round(sum(out[k]['seconds'] for k in LEGS
                                         if k in out), 1)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)

    ckpt = os.path.join(work, 'axis.ckpt')
    calls = {}

    trained = {}

    def cli(cli_args, label):
        stdout, calls[label] = run_cli(cli_args, label, args.device, work)
        if cli_args[0] == 'train':
            trained[label] = training(stdout, cli_args[1])
        return stdout

    def ensure_axis():
        # 1. axis training from scratch
        if not trained_through(ckpt, args.iters):
            cli(['train', ckpt, '--backbone', 'ResNet18FPN',
                 '--images', img, '--annotations', ann]
                + train_args(args.iters, res, mx, mile), 'train-axis')

    def record(leg, stdout, annotations=ann, iou_type='bbox'):
        # no stats where the CLI found no detections (no score above the
        # threshold, as after --quick's 50 iterations): the leg says so (the
        # original records None, and its rerun runs the leg again)
        stats = parse_stats(stdout)
        detections = os.path.join(work, 'detections.json')
        if stats is None:
            if 'No detections!' not in stdout:
                raise RuntimeError(f'{leg}: no evaluator stats')
            stats = {'no_detections': True}
        else:
            stats['per_class_ap'] = per_class_ap(annotations, detections,
                                                 iou_type)
        if os.path.isfile(detections):
            os.remove(detections)
        out[leg] = dict(stats, seconds=round(sum(calls.values()), 1),
                        calls={k: round(v, 1) for k, v in calls.items()},
                        **({'training': dict(trained)} if trained else {}))
        calls.clear()
        trained.clear()
        flush()

    def todo(leg):
        return leg in args.legs and leg not in out

    # 2. checkpoint eval
    if todo('axis_ckpt'):
        ensure_axis()
        record('axis_ckpt', cli(
            ['infer', ckpt, '--images', img, '--annotations', ann,
             '--batch', 8, '--resize', res, '--max-size', mx], 'eval-ckpt'))

    # 3. bf16 engine export + eval (fixed-size letterbox path)
    if todo('axis_engine'):
        ensure_axis()
        eng = os.path.join(work, 'axis.engine')
        cli(['export', ckpt, eng, '--size', esize,
             '--dynamic-batch-opts', 1, 8, 8], 'export-bf16')
        record('axis_engine', cli(
            ['infer', eng, '--images', img, '--annotations', ann,
             '--batch', 8], 'eval-engine'))

    # 3b. checkpoint eval at the engine's letterbox geometry: the export's
    #     losslessness check (expected delta ~0 against axis_engine)
    if todo('axis_ckpt_at_engine_scale'):
        ensure_axis()
        record('axis_ckpt_at_engine_scale', cli(
            ['infer', ckpt, '--images', img, '--annotations', ann,
             '--batch', 8, '--fixed-size', esize], 'eval-ckpt-engine-scale'))

    # 4. INT8 calibration: absmax vs percentile vs KL entropy
    for tag, extra in INT8_LEGS:
        if not todo(tag):
            continue
        ensure_axis()
        eng8 = os.path.join(work, f'{tag}.engine')
        cli(['export', ckpt, eng8, '--size', esize, '--int8',
             '--calibration-images', img, '--calibration-batches', 4,
             '--dynamic-batch-opts', 1, 8, 8] + extra, f'export-{tag}')
        record(tag, cli(['infer', eng8, '--images', img, '--annotations',
                         ann, '--batch', 8], f'eval-{tag}'))

    # 5. rotated fine-tune from the axis checkpoint, gradients clipped to
    #    25: the fresh 6-delta box head's early gradients spike
    #    (extras/validate_synthetic.py:199-206)
    if todo('rotated_ckpt'):
        rckpt = os.path.join(work, 'rotated.ckpt')
        if trained_through(rckpt, args.rotated_iters):
            print(f'==> [train-rotated] reusing {rckpt} '
                  f'(already at iteration >= {args.rotated_iters})',
                  flush=True)
        else:
            ensure_axis()
            cli(['train', rckpt, '--backbone', 'ResNet18FPN',
                 '--images', rimg, '--annotations', rann, '--rotated-bbox',
                 '--fine-tune', ckpt, '--clip-grads', 25]
                + train_args(args.rotated_iters, res, mx, mile),
                'train-rotated')
        record('rotated_ckpt', cli(
            ['infer', rckpt, '--images', rimg, '--annotations', rann,
             '--rotated-bbox', '--batch', 8, '--resize', res,
             '--max-size', mx], 'eval-rotated'), rann, 'segm')

    flush()
    print(json.dumps({k: out[k].get('ap') for k in LEGS if k in out}))
    print('wrote', args.out)
    return out


if __name__ == '__main__':
    main()
