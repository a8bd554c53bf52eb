"""Cells of ``BENCHMARK.json`` cut to a size a CPU test holds: batch 2
on a 256 x 256 canvas, the configuration and the limits unchanged."""

from perfbench.lib import cell as cells

CANVAS = [256, 256]
VALID = [200, 240]


def small(name, precision=None):
    cell = cells.resolve(name)
    mix = dict(cell['mix'])
    mix.update(batch=2, canvas=CANVAS, valid=VALID, reference_block=2,
               pool=3 if mix['loop'] == 'train' else 4, check_requests=2,
               warmup_rounds=1, trace_seconds=1)
    cell['mix'] = mix
    if precision:
        cell['config_data'] = dict(cell['config_data'], precision=precision)
    return cell
