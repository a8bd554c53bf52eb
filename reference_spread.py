#!/usr/bin/env python3
"""Spread of ``chip_smoke.py``'s train-reference errors over weights.

    python3 reference_spread.py [seeds]

For the axis-aligned and the rotated ResNet50FPN (80 classes), each
seed's random init is saved and one fp32 SGD step runs on the card and
on the CPU (``chip_smoke.reference_errors``); for seed 0 the card also
runs against itself. One line per comparison: the relative errors of
the losses and of the parameter update (all, median tensor, worst
tensor). Needs one CUDA device; defaults to 6 seeds.
"""

import os
import sys
import tempfile

import torch

import chip_smoke


def main():
    if not torch.cuda.is_available():
        raise SystemExit('reference_spread: no CUDA device')
    from odtk_tpu_torch.model import Model

    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    card = torch.device('cuda', 0)
    print(chip_smoke.card(), flush=True)
    with tempfile.TemporaryDirectory(prefix='odtk_spread_') as root:
        for rotated in (False, True):
            for seed in range(seeds):
                path = os.path.join(root, f'{rotated}_{seed}.pth')
                Model('ResNet50FPN', classes=80, rotated_bbox=rotated) \
                    .initialize(seed).save({'path': path})
                pairs = [('cpu', card)] + ([(card, card)] if seed == 0
                                            else [])
                for devices in pairs:
                    e = chip_smoke.reference_errors(path, devices, rotated)
                    print(f'{"rotated" if rotated else "axis"} seed {seed} '
                          f'{devices[1]} vs {devices[0]}: losses '
                          f'{e["loss"]:.3g}, update all {e["total"]:.3g}, '
                          f'median {e["median"]:.3g}, worst '
                          f'{e["worst_err"]:.3g} ({e["worst"]})',
                          flush=True)


if __name__ == '__main__':
    main()
