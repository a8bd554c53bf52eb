"""The port of the train-to-AP oracle (``odtk_tpu_torch/validate_synthetic``)
held to the original (``extras/validate_synthetic.py``, imported by path
and left as it is) on the CPU, without training anything: the CLI runner
of both scripts is replaced by a stub that records each command, answers
with the port evaluator's 12 verbose lines, and writes a ``.ckpt`` that
records the iterations a ``train`` command asked for. ``--quick`` issues
the same CLI calls in the same order in both, leg by leg, apart from the
module name and the port's ``--device``; every call of the port parses
under its CLI. Also: ``parse_stats`` reads the evaluator's own output,
``--legs`` subsets merge into one JSON, a rerun skips the recorded legs,
``trained_through`` reads a checkpoint the port wrote, a training's
record reads the trainer's per-iteration losses and the optax count, the
per-class AP agrees with the evaluator's, and both packages' eval
loaders give the same batches at the engine legs' letterbox geometry.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from odtk_tpu.data import DataIterator as JaxIterator
from odtk_tpu_torch import main as cli
from odtk_tpu_torch import validate_synthetic as port
from odtk_tpu_torch.data import CocoEvaluator, CocoIndex, DataIterator
from odtk_tpu_torch.io.checkpoint import peek_iteration
from odtk_tpu_torch.io.msgpack import msgpack_serialize
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_decode_route import decode_route  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _original():
    spec = importlib.util.spec_from_file_location(
        'validate_synthetic_original',
        os.path.join(REPO, 'extras', 'validate_synthetic.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def verbose_eval(tmp_path_factory):
    """(the evaluator's verbose output, the stats it returned, a file of
    the detections as ``infer`` writes it, the ground truth) on jittered
    copies of a synthetic ground truth, with misses and false positives."""
    root = tmp_path_factory.mktemp('eval')
    _, ann = make_dataset(str(root), n_images=6, size=(96, 128), fmt='jpg')
    rng = np.random.RandomState(0)
    with open(ann) as f:
        gt = json.load(f)
    dets = []
    for a in gt['annotations']:
        if rng.rand() < 0.2:
            continue
        x, y, w, h = a['bbox']
        jit = rng.randn(4) * 2
        dets.append({'image_id': a['image_id'],
                     'category_id': a['category_id'],
                     'bbox': [x + jit[0], y + jit[1], w + jit[2], h + jit[3]],
                     'score': float(rng.rand())})
        dets.append({'image_id': a['image_id'], 'category_id': 1,
                     'bbox': [float(v) for v in rng.rand(4) * 40 + 5],
                     'score': float(rng.rand() * 0.5)})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = CocoEvaluator(CocoIndex(ann)).evaluate(dets, verbose=True)
    path = str(root / 'detections.json')
    with open(path, 'w') as f:
        json.dump({'annotations': dets}, f)
    return out.getvalue(), stats, path, ann


def test_parse_stats_reads_the_evaluators_verbose_lines(verbose_eval):
    text, stats, _, _ = verbose_eval
    got = port.parse_stats('loading...\n' + text + 'done\n')
    assert list(got) == port.STAT_NAMES
    np.testing.assert_allclose(list(got.values()), stats, rtol=0,
                               atol=5e-4 + 1e-9)
    assert 0 < got['ap'] < 1 and got['ap_large'] == -1.0
    assert port.parse_stats(text.replace(' AR large', ' XX')) is None


class _CliStub:
    """subprocess.run for the scripts' CLI runner: records the command
    and its keyword arguments, writes a ``.ckpt`` at a train command's
    checkpoint path recording its ``--iters``, answers with the
    evaluator's verbose lines."""

    def __init__(self, stdout):
        self.stdout = stdout
        self.calls = []

    def __call__(self, cmd, **kwargs):
        self.calls.append((list(cmd), kwargs))
        args = cmd[3:]
        if args[0] == 'train':
            iters = int(args[args.index('--iters') + 1])
            with open(args[1], 'wb') as f:
                f.write(msgpack_serialize({'iteration': iters,
                                           'state_dict': {}}))
        return subprocess.CompletedProcess(cmd, 0, stdout=self.stdout,
                                           stderr='')


def _run_original(tmp_path, monkeypatch, stub):
    work, out = str(tmp_path / 'jax'), str(tmp_path / 'jax.json')
    monkeypatch.setattr(subprocess, 'run', stub)
    monkeypatch.setattr(sys, 'argv', ['validate_synthetic.py', '--quick',
                                      '--workdir', work, '--out', out])
    _original().main()
    with open(out) as f:
        return work, json.load(f)


def _run_port(tmp_path, monkeypatch, stub, *extra, name='port'):
    work, out = str(tmp_path / name), str(tmp_path / f'{name}.json')
    monkeypatch.setattr(subprocess, 'run', stub)
    port.main(['--quick', '--device', 'cpu', '--workdir', work, '--out',
               out] + list(extra))
    with open(out) as f:
        return work, json.load(f)


def test_quick_issues_the_originals_cli_calls(verbose_eval, tmp_path,
                                              monkeypatch):
    """Leg by leg the same commands as the original's ``--quick`` run
    (workdirs aside), with ``odtk_tpu_torch.main`` for ``odtk_tpu.main``
    and ``--device cpu`` appended, no JAX variable in their environment;
    each parses under the port's CLI; every leg gets the 12 stats and its
    seconds, and the JSON names the device."""
    jstub, pstub = _CliStub(verbose_eval[0]), _CliStub(verbose_eval[0])
    jwork, jout = _run_original(tmp_path, monkeypatch, jstub)
    pwork, pout = _run_port(tmp_path, monkeypatch, pstub)
    assert len(pstub.calls) == len(jstub.calls) == 13
    for (jcmd, _), (pcmd, kwargs) in zip(jstub.calls, pstub.calls):
        assert jcmd[:3] == [sys.executable, '-m', 'odtk_tpu.main']
        assert pcmd[:3] == [sys.executable, '-m', 'odtk_tpu_torch.main']
        assert pcmd[-2:] == ['--device', 'cpu']
        assert [a.replace(pwork, 'W') for a in pcmd[3:-2]] == \
            [a.replace(jwork, 'W') for a in jcmd[3:]]
        assert kwargs['cwd'] == pwork
        assert REPO in kwargs['env']['PYTHONPATH'].split(os.pathsep)
        assert ('ODTK_DEBUG' in kwargs['env']) == (pcmd[3] == 'train')
        assert not {k for k in set(kwargs['env']) - set(os.environ)
                    if k.startswith(('JAX', 'XLA'))}
        cli.parse(pcmd[3:])
    assert pout['recipe'] == jout['recipe'] and pout['device'] == 'cpu'
    for leg in port.LEGS:
        stats = {k: pout[leg][k] for k in port.STAT_NAMES}
        assert stats == jout[leg]
        assert pout[leg]['seconds'] >= 0
    assert set(pout['axis_ckpt']['calls']) == {'train-axis', 'eval-ckpt'}


def test_legs_merge_and_a_rerun_skips_recorded_legs(verbose_eval, tmp_path,
                                                    monkeypatch):
    """Two ``--legs`` calls with one workdir and one ``--out`` give one
    JSON of both calls' legs, training the axis model once; a third call
    of every leg runs only the four left (7 calls), and a fourth runs no
    CLI call."""
    stub = _CliStub(verbose_eval[0])
    _run_port(tmp_path, monkeypatch, stub, '--legs', 'axis_ckpt')
    labels = [cmd[3] for cmd, _ in stub.calls]
    assert labels == ['train', 'infer']
    _, out = _run_port(tmp_path, monkeypatch, stub, '--legs',
                       'rotated_ckpt', 'int8_p999')
    labels = [cmd[3] for cmd, _ in stub.calls[2:]]
    assert labels == ['export', 'infer', 'train', 'infer']
    assert '--rotated-bbox' in stub.calls[4][0]
    assert {k for k in port.LEGS if k in out} == {
        'axis_ckpt', 'int8_p999', 'rotated_ckpt'}
    _, out = _run_port(tmp_path, monkeypatch, stub)
    assert len(stub.calls) == 6 + 7
    assert all(leg in out for leg in port.LEGS)
    _, again = _run_port(tmp_path, monkeypatch, stub)
    assert len(stub.calls) == 13
    assert {k: again[k] for k in port.LEGS} == {k: out[k] for k in port.LEGS}


def test_a_leg_without_detections_is_recorded(verbose_eval, tmp_path,
                                              monkeypatch):
    """A leg whose CLI found no detections holds no stats and says so, and
    a rerun skips it as a recorded leg; an output with neither the stats
    nor "No detections!" raises."""
    stub = _CliStub('Running inference...\nNo detections!\n')
    _, out = _run_port(tmp_path, monkeypatch, stub, '--legs', 'axis_ckpt')
    assert out['axis_ckpt']['no_detections'] and 'ap' not in out['axis_ckpt']
    _, again = _run_port(tmp_path, monkeypatch, stub, '--legs', 'axis_ckpt')
    assert [cmd[3] for cmd, _ in stub.calls] == ['train', 'infer']
    assert again['axis_ckpt'] == out['axis_ckpt']
    stub.stdout = 'Running inference...\n'
    with pytest.raises(RuntimeError, match='no evaluator stats'):
        _run_port(tmp_path, monkeypatch, stub, '--legs', 'axis_engine')


def test_a_leg_trains_the_axis_model_it_needs(verbose_eval, tmp_path,
                                              monkeypatch):
    """``--legs int8_absmax`` in a fresh workdir trains the axis model
    first, and the output refuses to be the JAX record."""
    stub = _CliStub(verbose_eval[0])
    _run_port(tmp_path, monkeypatch, stub, '--legs', 'int8_absmax')
    assert [cmd[3] for cmd, _ in stub.calls] == ['train', 'export', 'infer']
    with pytest.raises(SystemExit):
        port.parse(['--out', os.path.join(REPO, 'VALIDATION.json')])


def test_trained_through_reads_a_port_ckpt(tmp_path):
    """The iteration of a ``.ckpt`` the port wrote; a truncated file is
    not trained through (``peek_iteration`` raises a ValueError)."""
    path = str(tmp_path / 'm.ckpt')
    assert not port.trained_through(path, 1)
    Model('ResNet18FPN', classes=3).initialize(0).save(
        {'path': path, 'iteration': 7})
    assert port.trained_through(path, 7)
    assert not port.trained_through(path, 8)
    with open(path, 'r+b') as f:
        f.truncate(100)
    with pytest.raises(ValueError, match='truncated'):
        peek_iteration(path)
    assert not port.trained_through(path, 1)


@pytest.mark.parametrize('emit', ['f32', 'u8'])
def test_letterbox_batches_equal_jax(tmp_path, decode_route, emit):
    """The engine legs' geometry: 320x400 JPEGs letterboxed to 512 x 512
    (the engine's f32 feed, and the checkpoint's u8 feed under
    ``--fixed-size 512``) give the same batches, image scales and ids in
    both packages' loaders."""
    img, ann = make_dataset(str(tmp_path), n_images=3, size=(320, 400),
                            max_boxes=3, fmt='jpg', seed=11)
    kw = dict(resize=320, max_size=512, batch_size=2, stride=128, world=1,
              annotations=ann, training=False, fixed_size=(512, 512),
              emit=emit, num_threads=1)
    got = list(DataIterator(img, **kw))
    want = list(JaxIterator(img, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.asarray(g[0]).shape[1:3] == (512, 512)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_per_class_ap_averages_to_the_evaluators_ap(verbose_eval, tmp_path):
    """The per-class AP of an ``infer`` output file: its mean over the
    classes with ground truth is the evaluator's AP@[.5:.95]; no file,
    no per-class AP."""
    _, stats, path, ann = verbose_eval
    got = port.per_class_ap(ann, path, 'bbox')
    assert len(got) == 3 and all(-1 <= v <= 1 for v in got)
    present = [v for v in got if v > -1]
    np.testing.assert_allclose(np.mean(present), stats[0], atol=2e-4)
    assert port.per_class_ap(ann, str(tmp_path / 'none.json'), 'bbox') is None


def test_training_record_groups_losses_by_100():
    """The (focal, box) means of each 100 ``ODTK_DEBUG`` lines, the last
    group short; no checkpoint optimizer state, no applied count."""
    lines = ''.join(f'  debug it{i}: cl={1 + i % 2:.4f} bl={i / 100:.4f} '
                    f'shape=(8, 3, 384, 512)\n' for i in range(150))
    read = {'iteration': 150, 'state_dict': {}}
    with mock.patch('odtk_tpu_torch.io.checkpoint.read', return_value=read):
        got = port.training('Training model...\n' + lines + 'Saving\n',
                            'm.ckpt')
    assert got == {'iterations': 150, 'applied': None,
                   'loss_per_100': [[1.5, 0.495], [1.5, 1.245]]}


def test_training_record_of_a_cli_run(tmp_path, monkeypatch, capsys):
    """``train`` under ``ODTK_DEBUG`` prints each iteration's losses as the
    JAX trainer does; the record of its output and ``.ckpt`` holds the 2
    iterations, 2 updates applied (the optax count) and their mean."""
    img, ann = make_dataset(str(tmp_path), n_images=2, size=(64, 96),
                            fmt='jpg')
    path = str(tmp_path / 'm.ckpt')
    monkeypatch.setenv('ODTK_DEBUG', '1')
    out = cli.main(['train', path, '--images', img, '--annotations', ann,
                    '--backbone', 'ResNet18FPN', '--classes', '3',
                    '--batch', '2', '--resize', '64', '--max-size', '96',
                    '--jitter', '64', '64', '--iters', '2', '--warmup', '1',
                    '--milestones', '100', '--full-precision', '--override',
                    '--no-pretrained', '--device', 'cpu'])
    got = port.training(capsys.readouterr().out, path)
    assert got['iterations'] == got['applied'] == 2
    mean = np.mean([(c, b) for _, c, b in out['losses']], axis=0)
    np.testing.assert_allclose(got['loss_per_100'], [mean], atol=1e-4)
