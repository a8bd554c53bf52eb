"""The benchmark of ``odtk_tpu_torch`` on NVIDIA H100 cards.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(weights and inputs made on the card from the seed, the program's first
steps, every shape warmed up), a measured window of ``--seconds``, then
the check of what the window produced against the plain reference. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared
number beside its limit (also the last lines of standard error).

It exits non-zero and prints no result when there is no CUDA card, or
fewer than the cell asks for, or when JAX or the JAX package was loaded.
Every cache lives in ``.perfbench_cache/`` in the checkout, the port's
kernels in ``odtk_tpu_torch/_build/``.
"""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, '.perfbench_cache')


def _caches():
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                     ('CUDA_CACHE_PATH', 'nv')):
        os.environ[var] = os.path.join(CACHE, sub)


def _card():
    try:
        got = subprocess.run(['nvidia-smi', '-i', '0', '--query-gpu='
                              'name,power.limit', '--format=csv,noheader'],
                             capture_output=True, text=True, timeout=30)
        return got.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi unavailable'


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _caches()
    # the script's own folder first on the path would shadow packages
    # with its subfolders' names
    sys.path[0] = ROOT
    from perfbench.lib import cell as cells

    cell = cells.resolve(args.workload)
    import torch

    chips = cell['chips']
    if chips != 1:
        print(f'perfbench: the cell asks for {chips} cards; this harness runs '
              'a cell on one', file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f'perfbench: the cell needs {chips} CUDA card(s), this machine '
              f'has {have}', file=sys.stderr)
        return 2
    out = cells.run(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                    STARTED)
    found = sorted(set(out['modules']) | set(cells.forbidden_modules()))
    if found:
        print(f'perfbench: forbidden modules loaded: {found}',
              file=sys.stderr)
        return 3
    return report(cell, out, bool(args.trace), chips,
                  torch.cuda.get_device_name(0))


def report(cell, out, trace, chips, kind):
    """Print the run's lines and its JSON result (``kind``: the card's
    name); 0 on success."""
    from perfbench.lib import judge

    correct, checks = judge.verdict(out['numbers'], cell['limits'])
    units = {m['name']: m['unit'] for m in cell['end_to_end']}
    units.update({m['name']: m['unit'] for m in cell['per_layer']})
    if trace:
        values = out['per_layer']
    else:
        values = {m['name']: out['e2e'][m['name']]
                  for m in cell['end_to_end']}
    device = {'platform': 'gpu', 'kind': kind,
              'count': chips, 'memory_peak_bytes': int(out['peak'])}
    if trace:
        device['busy_s'], device['window_s'] = out['busy']
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'],
              'metrics': {k: {'value': v, 'unit': units[k]}
                          for k, v in values.items()},
              'device': device}
    if trace:
        result['breakdown'] = out['breakdown']
    result['checks'] = {name: {'value': v, 'limit': lim}
                        for name, v, lim in checks}
    for line in out['log']:
        print(line, file=sys.stderr)
    print(f'card: {_card()}', file=sys.stderr)
    if trace:
        for k, v in out['per_layer'].items():
            print(f'{k}: {v!r} {units[k]}', file=sys.stderr)
    for k, v in out['e2e'].items():
        print(f'{k}: {v!r}', file=sys.stderr)
    for name, v, lim in checks:
        print(f'check {name}: {v!r} limit {lim!r} '
              f'{"ok" if v <= lim else "FAILED"}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
