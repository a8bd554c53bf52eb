"""The run's result line, its refusal without a card, and its imports."""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from perfbench import run as runner
from perfbench.lib import cell as cells
from perfbench.tests.small import small

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('name,trace', [('r50fpn-train-b8', False),
                                        ('r50fpn-infer-b8', True)])
def test_result_line_keys(name, trace):
    cell = small(name)
    out = cells.run(cell, 2 ** 31 + 5, 0.5, trace, 'cpu', 0.0)
    assert out['modules'] == []
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert runner.report(cell, out, trace, 1, 'test') == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = KEYS + (['breakdown'] if trace else []) + ['checks']
    assert list(result) == want
    assert result['device']['platform'] == 'gpu'
    assert set(result['checks']) == set(cell['limits'])
    if trace:
        assert set(result['device']) >= {'busy_s', 'window_s'}
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert set(result['metrics']) == {m['name']
                                          for m in cell['end_to_end']}


def test_no_card_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    got = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', 'r50fpn-train-b8',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ''
    assert 'CUDA card' in got.stderr


IMPORTS = r'''
import sys
sys.path[0] = {root!r}
from perfbench import run
from perfbench.lib import cell as cells, loops, trace, readers, judge
from perfbench import control
import odtk_tpu_torch.model, odtk_tpu_torch.train, odtk_tpu_torch.parallel
for w in cells.benchmark()['workloads']:
    cell = cells.resolve(w['name'])
    for m in cell['per_layer']:
        cells.reader(m['name'])
print(sorted({{m.split('.')[0] for m in sys.modules}}))
'''


def test_run_imports_no_jax():
    got = subprocess.run([sys.executable, '-c',
                          IMPORTS.format(root=cells.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert got.returncode == 0, got.stderr
    loaded = set(ast.literal_eval(got.stdout.strip().splitlines()[-1]))
    assert 'odtk_tpu_torch' in loaded
    assert not loaded & {'jax', 'jaxlib', 'flax', 'odtk_tpu'}


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['r50fpn-train-b8', 'r50fpn-infer-b8'])
def test_cell_on_the_card(cuda_device, name):
    got = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', name, '--seed',
         str(2 ** 31 + 77), '--seconds', '3', '--trace', '0'],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-2000:]
    result = json.loads(got.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
