"""Readings that set a cell's correctness limits, on the card.

    python3 perfbench/control.py --workload NAME --seeds S [S ...]
        [--program] [--json FILE]

For each seed, in one process: the control (the plain reference
computed in fp8 in the program's place, judged by the fp32 reference)
and the faults that the cell can have, planted in the reference in the
program's place: training, half of each batch left out (the mean over
the rest); serving, one detection's class altered, one's box edge moved
by a tenth of its width, and three faults of the selection: each
image's best candidate left out of the NMS, the NMS suppressing at an
IoU of 0.3 in place of the configuration's, and only the first half of
the detections returned. With ``--program``, also the program's own
numbers (training: its first three steps; serving: a short window at
the cell's load). The benchmark's runs never run this.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(cell, seed, device, program=False):
    from perfbench.lib import judge, loops, weights

    config, mix = cell['config_data'], cell['mix']
    state = weights.state_dict(config, seed, device)
    reference = loops.reference_train(config, mix, seed, device, state=state)
    out = {}
    for name, kw in (('control', {'fp8': True}),
                     ('half_batch', {'fault': 'half'})):
        got = loops.reference_train(config, mix, seed, device, state=state,
                                    **kw)
        out[name] = judge.train_numbers(got, reference)
    if program:
        run = loops.train_setup(config, mix, seed, device)
        readings = run['readings']
        loops.free(run, device)
        out['program'] = judge.train_numbers(readings, reference)
    return out


def serve_readings(cell, seed, device, program=False):
    import torch

    from perfbench.lib import inputs, judge, loops, weights
    from perfbench.lib.trace import Spans
    from perfbench.reference import retinanet as ref

    config, mix = cell['config_data'], cell['mix']
    state = weights.state_dict(config, seed, device)
    pool = inputs.eval_pool(seed, mix, device)
    out = {name: {} for name in ('control', 'altered_class', 'moved_box',
                                 'best_dropped', 'wide_nms', 'short_list')}

    def worst(name, numbers):
        for k, v in numbers.items():
            out[name][k] = max(out[name].get(k, 0.0), v)

    for batch in pool:
        logits, boxes, sides = loops.reference_detections(
            config, mix, state, batch, device)
        lq, bq, _ = loops.reference_detections(config, mix, state, batch,
                                               device, fp8=True)
        args = (config['fused_top_n'], config['threshold'], config['nms'],
                config['detections'])

        def judged(dets):
            return judge.detection_numbers(dets, logits, boxes, sides, config)

        worst('control', judged(ref.detect(lq, bq, *args)))
        del lq, bq
        s, b, c = ref.detect(logits, boxes, *args)
        c2 = c.clone()
        c2[0, 0] = (c2[0, 0] + 1) % config['classes']
        worst('altered_class', judged((s, b, c2)))
        b2 = b.clone()
        b2[0, 0, 0] += 0.1 * (b2[0, 0, 2] - b2[0, 0, 0] + 1)
        worst('moved_box', judged((s, b2, c)))
        best = logits.clone()
        flat = best.view(len(best), -1)
        flat[torch.arange(len(flat)), flat.argmax(1)] = -math.inf
        worst('best_dropped', judged(ref.detect(best, boxes, *args)))
        del best, flat
        worst('wide_nms', judged(ref.detect(logits, boxes, args[0], args[1],
                                            0.3, args[3])))
        half = args[3] // 2
        s2 = torch.cat([s[:, :half], torch.zeros_like(s[:, half:])], 1)
        worst('short_list', judged((s2, b, c)))
        del logits, boxes
        torch.cuda.empty_cache() if device.type == 'cuda' else None
    if program:
        run = loops.serve_setup(config, mix, seed, device)
        served = loops.serve_window(run, 1.0, device, Spans(False))['served']
        check_state = run.pop('state')
        loops.free(run, device)
        out['program'], _ = loops.serve_check(config, mix, seed, served,
                                              check_state, device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--program', action='store_true')
    parser.add_argument('--json', default=None)
    args = parser.parse_args(argv)
    sys.path[0] = ROOT
    import torch

    from perfbench.lib import cell as cells

    if not torch.cuda.is_available():
        print('control: no CUDA card', file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    device = torch.device('cuda', 0)
    fn = train_readings if cell['mix']['loop'] == 'train' else serve_readings
    result = {'workload': args.workload,
              'card': torch.cuda.get_device_name(0), 'seeds': {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        result['seeds'][seed] = fn(cell, seed, device, args.program)
        print(f'seed {seed} ({time.perf_counter() - t0:.1f} s): '
              f'{json.dumps(result["seeds"][seed])}', flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, 'w') as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
