#!/usr/bin/env python3
"""Print anchor tables as C++ initializer lists for strides 8..128.

The port of ``extras/generate_anchors.py`` (the original's
``extras/cppapi/generate_anchors.py``), on this package's
``ops/anchors.py``: the per-stride anchor offsets (axis-aligned, and the
axis member of the rotated pair with ``--rotated``) for embedding in C++
deployment configs. Same flags, same output.

    python -m odtk_tpu_torch.extras.generate_anchors [--rotated]
"""

import argparse

import numpy as np

from ..ops.anchors import generate_anchors, generate_anchors_rotated


def _literal(v):
    s = f'{v:.7g}'
    if '.' not in s and 'e' not in s and 'inf' not in s:
        s += '.0'
    return s + 'f'


def main(args=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ratios', type=float, nargs='+', default=[1.0, 2.0, 0.5])
    p.add_argument('--scales', type=float, nargs='+',
                   default=[4 * 2 ** (i / 3) for i in range(3)])
    p.add_argument('--angles', type=float, nargs='+',
                   default=[-np.pi / 6, 0, np.pi / 6])
    p.add_argument('--rotated', action='store_true')
    p.add_argument('--strides', type=int, nargs='+',
                   default=[8, 16, 32, 64, 128])
    args = p.parse_args(args)

    for stride in args.strides:
        if args.rotated:
            table = generate_anchors_rotated(stride, args.ratios,
                                             args.scales, args.angles)[0]
        else:
            table = generate_anchors(stride, args.ratios, args.scales)
        flat = ', '.join(_literal(v) for v in np.asarray(table).reshape(-1))
        print(f'const std::vector<float> anchors_{stride} = {{{flat}}};')


if __name__ == '__main__':
    main()
