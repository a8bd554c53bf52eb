"""The JAX CLI's options in odtk_tpu_torch's CLI, on the CPU: every option
string of ``odtk_tpu.main``'s ``train``, ``infer`` and ``export``
subcommands parses in the port to the value the JAX parser gives it
(collected from the JAX parser itself, so a flag added there later is
caught). The JAX CLI's two layout switches, ``--fused-stem /
--no-fused-stem`` and ``--wpack-layer1 / --no-wpack-layer1``, pick
between TPU layouts of one function; in the port both are accepted,
inert, and say so: the ResNet stem runs its kernel wrappers in training,
inference and export whatever they say.
"""

import argparse
import io
import random
from unittest import mock

import numpy as np
import pytest
import torch

from odtk_tpu import main as jax_main
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.backbones import resnet
from odtk_tpu_torch.export import Engine
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
# positional and required arguments of each subcommand
BASE = {'train': ['train', 'm.pth', '--annotations', 'a.json'],
        'infer': ['infer', 'm.pth'],
        'export': ['export', 'm.pth', 'm.engine']}
# values for free-form string options that the port checks
VALUES = {'backbone': 'ResNet18FPN'}


def _subparsers(module):
    """{command: subparser} of ``module.parse``'s parser."""
    captured = {}

    def capture(self, args=None, namespace=None):
        captured['parser'] = self
        return argparse.Namespace()

    with mock.patch.object(argparse.ArgumentParser, 'parse_args', capture):
        module.parse(['infer', 'm.pth'])
    for action in captured['parser']._actions:
        if isinstance(action, argparse._SubParsersAction):
            return dict(action.choices)
    raise AssertionError('no subcommands')


def _values(action):
    """Command-line values for one option of the JAX parser."""
    if action.nargs == 0:
        return []
    if action.choices:
        value = str(list(action.choices)[-1])
    elif action.dest in VALUES:
        value = VALUES[action.dest]
    elif action.type is int:
        value = '3'
    elif action.type is float:
        value = '0.25'
    else:
        value = 'x'
    return [value] * (action.nargs if isinstance(action.nargs, int) else 1)


@pytest.mark.parametrize('command', ['train', 'infer', 'export'])
def test_every_jax_option_parses_in_the_port(command):
    """Each option string of the JAX subcommand, with values of its type,
    parses under ``odtk_tpu_torch.main.parse`` to the JAX parser's value
    of the same destination."""
    jax_parser = _subparsers(jax_main)[command]
    options = [(o, a) for a in jax_parser._actions for o in a.option_strings
               if not isinstance(a, argparse._HelpAction)]
    assert {'--fused-stem', '--no-fused-stem', '--wpack-layer1',
            '--no-wpack-layer1'} <= {o for o, _ in options}
    for option, action in options:
        argv = BASE[command] + [option] + _values(action)
        want = getattr(jax_main.parse(argv), action.dest)
        got = getattr(cli.parse(argv), action.dest)
        assert got == want, (argv, got, want)


def _stem_calls(monkeypatch):
    """Counts the calls of the stem kernel's two wrappers in the ResNet
    forward (the primal and the argmax one)."""
    calls = {'bn_relu_pool': 0, 'bn_relu_pool_train': 0}
    for name in calls:
        fn = getattr(resnet, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(resnet, name, counted)
    return calls


def _said(out):
    """The lines of ``out`` that say a layout switch is ignored."""
    return [line for line in out.splitlines()
            if line.startswith(('--fused-stem ignored',
                                '--wpack-layer1 ignored'))]


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('flags')
    img, ann = make_dataset(str(root), n_images=2, size=(64, 96), fmt='jpg')
    ckpt = str(root / 'model.pth')
    Model('ResNet18FPN', classes=CLASSES).initialize(0).save(
        {'path': ckpt})
    return root, img, ann, ckpt


@pytest.mark.parametrize('flag', ['--no-fused-stem', '--fused-stem'])
def test_cli_train_stem_flags_keep_the_kernel(data, tmp_path, monkeypatch,
                                             capsys, flag):
    """``train`` for one step calls the stem's argmax wrapper once with
    ``flag`` as without it, prints the flag's one line, and gives the
    default run's loss from the same seed."""
    _, img, ann, _ = data
    calls = _stem_calls(monkeypatch)
    losses = []
    for flags in ([], [flag]):
        before = dict(calls)
        random.seed(0)
        out = cli.main([
            'train', str(tmp_path / 'm.pth'), '--images', img,
            '--annotations', ann, '--backbone', 'ResNet18FPN', '--classes',
            str(CLASSES), '--batch', '2', '--resize', '64', '--max-size',
            '96', '--jitter', '64', '64', '--iters', '1', '--warmup', '1',
            '--milestones', '100', '--full-precision', '--override',
            '--no-pretrained', '--device', 'cpu'] + flags)
        assert len(out['losses']) == 1 and np.isfinite(out['losses']).all()
        assert {k: calls[k] - before[k] for k in calls} == {
            'bn_relu_pool': 0, 'bn_relu_pool_train': 1}, flags
        said = _said(capsys.readouterr().out)
        assert said == (['--fused-stem ignored: the ResNet stem always runs '
                         'its CUDA kernel, which computes the same function']
                        if flags else []), flags
        losses.append(out['losses'])
    assert losses[0] == losses[1]


def _graph_code(path):
    engine = Engine.load(path)
    program = torch.export.load(io.BytesIO(engine.blobs['1']))
    return '\n'.join(m.code for m in program.graph_module.modules()
                     if hasattr(m, 'code'))


@pytest.mark.parametrize('flags', [[], ['--fused-stem'], ['--no-fused-stem']])
def test_export_engine_stem_operator(data, tmp_path, capsys, flags):
    """A CPU engine holds ``odtk::bn_relu_pool`` (and ``odtk::nms``)
    whether it was exported with the default, ``--fused-stem`` or
    ``--no-fused-stem``; either flag prints its one line."""
    _, _, _, ckpt = data
    path = str(tmp_path / 'm.engine')
    cli.main(['export', ckpt, path, '--size', '128', '--full-precision',
              '--dynamic-batch-opts', '1', '1', '1', '--device', 'cpu']
             + flags)
    assert len(_said(capsys.readouterr().out)) == len(flags)
    code = _graph_code(path)
    assert 'torch.ops.odtk.nms.default' in code
    assert 'torch.ops.odtk.bn_relu_pool.default' in code


def test_wpack_layer1_prints_its_line_and_changes_nothing(data, capsys,
                                                          monkeypatch):
    """``infer`` with ``--wpack-layer1``, ``--no-wpack-layer1``,
    ``--fused-stem`` or ``--no-fused-stem`` prints one line saying the
    switch is ignored, calls the primal stem wrapper once a batch as the
    default does, and gives the default's detections."""
    root, img, ann, ckpt = data
    calls = _stem_calls(monkeypatch)
    stats, dets = [], []
    runs = ([], ['--wpack-layer1'], ['--no-wpack-layer1'], ['--fused-stem'],
            ['--no-fused-stem'])
    for i, flags in enumerate(runs):
        before = dict(calls)
        det = str(root / f'det{i}.json')
        out = cli.main(['infer', ckpt, '--images', img, '--annotations',
                        ann, '--batch', '2', '--resize', '64',
                        '--max-size', '96', '--threshold', '0.001',
                        '--output', det, '--device', 'cpu'] + flags)
        said = _said(capsys.readouterr().out)
        assert len(said) == len(flags) and all(
            line.startswith(flags[0].replace('--no-', '--') + ' ignored')
            for line in said), (flags, said)
        assert {k: calls[k] - before[k] for k in calls} == {
            'bn_relu_pool': 1, 'bn_relu_pool_train': 0}, flags
        stats.append(out['stats'])
        with open(det) as f:
            dets.append(f.read())
    assert all(d == dets[0] for d in dets)
    assert stats[0] is not None
