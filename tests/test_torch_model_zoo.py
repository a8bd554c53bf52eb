"""The ImageNet default init of a fresh model (``io/model_zoo.py``) held
against the JAX package's.

No test here touches the network: in-process, ``urllib.request.urlopen``
is patched to raise (or to serve bytes from memory where a download is
the subject), and the one CLI subprocess runs on a cache hit with the
same patch. The torchvision-named files are drawn from numpy seeds.
"""

import io
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from odtk_tpu import main as jax_main
from odtk_tpu.io import model_zoo as jax_zoo
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.io import model_zoo
from odtk_tpu_torch.io.torch_import import load_backbone_weights
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R18 = 'resnet18-5c106cde.pth'
CLASSIFIERS = {'ResNet18FPN': {'fc.weight': (1000, 512), 'fc.bias': (1000,)},
               'MobileNetV2FPN': {'classifier.1.weight': (1000, 1280),
                                  'classifier.1.bias': (1000,)}}


def _no_network(*args, **kwargs):
    raise AssertionError('network touched')


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """Both packages' zoo state reset, and ``urlopen`` raising."""
    for zoo in (model_zoo, jax_zoo):
        zoo._OFFLINE[0] = False
        zoo._WARNED.clear()
    monkeypatch.setattr('urllib.request.urlopen', _no_network)
    yield
    for zoo in (model_zoo, jax_zoo):
        zoo._OFFLINE[0] = False


def _torchvision_sd(backbone, seed):
    """A torchvision-named state_dict of ``backbone``, numpy-seeded: the
    port's features' names and shapes (running variances positive), a
    ``num_batches_tracked`` a batch norm and the classifier head."""
    rng = np.random.RandomState(seed)
    feats = Model(backbone, classes=2).module.backbones[backbone].features
    sd = {}
    for k, v in feats.state_dict().items():
        x = rng.randn(*v.shape).astype(np.float32)
        if k.endswith('running_var'):
            x = np.abs(x) + 0.5
            sd[k[:-len('running_var')] + 'num_batches_tracked'] = \
                torch.tensor(7)
        sd[k] = torch.from_numpy(x)
    for k, shape in CLASSIFIERS.get(backbone, {}).items():
        sd[k] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return sd


def _weights(backbone, sd):
    prefix = f'backbones.{backbone}.features.'
    return {prefix + k: v for k, v in sd.items()
            if not k.startswith(('fc.', 'classifier.'))
            and not k.endswith('num_batches_tracked')}


def _zoo_dir(tmp_path, backbone, seed):
    d = tmp_path / 'zoo'
    d.mkdir(exist_ok=True)
    sd = _torchvision_sd(backbone, seed)
    fname = model_zoo.ZOO_URLS[backbone].rsplit('/', 1)[-1]
    torch.save(sd, str(d / fname))
    return d, sd


# ------------------------------------------- counterparts of test_model_zoo
def test_fetch_cache_hit_no_network(tmp_path, monkeypatch):
    d = tmp_path / 'weights'
    d.mkdir()
    (d / R18).write_bytes(b'x')
    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(d))
    assert model_zoo.fetch('ResNet18FPN') == str(d / R18)
    assert model_zoo.fetch('ResNet18C4') == str(d / R18)


def test_fetch_offline_warns_once_and_short_circuits(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(tmp_path / 'empty'))
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'th'))
    calls = []

    def fail(*a, **k):
        calls.append(1)
        raise OSError('no route to host')
    monkeypatch.setattr('urllib.request.urlopen', fail)
    assert model_zoo.fetch('ResNet18FPN') is None
    assert model_zoo.fetch('ResNet50FPN') is None   # short-circuited
    assert len(calls) == 1
    err = capsys.readouterr().err
    assert err.count('FROM SCRATCH') == 1
    assert not os.listdir(tmp_path / 'empty')      # the .part went


def test_fetch_unknown_backbone_warns(capsys):
    assert model_zoo.fetch('NoSuchNetFPN') is None
    assert 'no ImageNet weights known' in capsys.readouterr().err


def test_init_pretrained_from_cached_file(tmp_path, monkeypatch):
    d, sd = _zoo_dir(tmp_path, 'ResNet18FPN', seed=3)
    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(d))
    m = Model('ResNet18FPN', classes=2).initialize(0)
    assert model_zoo.init_pretrained(m, verbose=False) == ['ResNet18FPN']
    got = m.module.state_dict()[
        'backbones.ResNet18FPN.features.conv1.weight']
    assert torch.equal(got, sd['conv1.weight'])


@pytest.mark.parametrize('backbone,probe_key', [
    ('ResNeXt50_32x4dFPN', 'layer1.0.conv2.weight'),   # grouped conv
    ('MobileNetV2FPN', 'features.3.conv.0.0.weight'),  # nested Sequentials
])
def test_name_map_roundtrip(tmp_path, backbone, probe_key):
    """Torchvision-named files fill every family the zoo covers: each
    tensor of the file lands in the backbone unchanged."""
    sd = _torchvision_sd(backbone, seed=5)
    assert probe_key in sd
    path = str(tmp_path / 'w.pth')
    torch.save(sd, path)
    m = Model(backbone, classes=2).initialize(0)
    load_backbone_weights(m, backbone, path)
    own = m.module.state_dict()
    for k, v in _weights(backbone, sd).items():
        assert torch.equal(own[k], v), k


# ------------------------------------------------------- equal to the JAX
@pytest.mark.parametrize('env', [
    {}, {'ODTK_WEIGHTS_DIR': 'w'}, {'TORCH_HOME': 'th'},
    {'ODTK_WEIGHTS_DIR': 'w', 'TORCH_HOME': 'th'}])
def test_urls_and_cache_dirs_equal_jax(tmp_path, monkeypatch, env):
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    for key in ('ODTK_WEIGHTS_DIR', 'TORCH_HOME'):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, str(tmp_path / value))
    assert model_zoo.ZOO_URLS == jax_zoo.ZOO_URLS
    assert len(model_zoo.ZOO_URLS) == 10
    assert model_zoo._cache_dirs() == jax_zoo._cache_dirs()
    assert model_zoo._cache_dirs()[-1].endswith(
        os.path.join('hub', 'checkpoints'))


@pytest.mark.parametrize('backbone', ['ResNet18FPN', 'MobileNetV2FPN'])
def test_init_pretrained_bit_equal_to_jax(tmp_path, monkeypatch, backbone):
    """One torchvision file through both packages' ``init_pretrained``:
    every backbone tensor of the port equals JAX's
    ``variables_to_state_dict`` and the file, bit for bit."""
    d, sd = _zoo_dir(tmp_path, backbone, seed=11)
    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(d))
    port = Model(backbone, classes=2).initialize(0)
    jmodel = JaxModel(backbones=backbone, classes=2)
    jmodel.initialize(rng=0, image_size=(64, 64))
    assert model_zoo.init_pretrained(port, verbose=False) == [backbone]
    assert jax_zoo.init_pretrained(jmodel, verbose=False) == [backbone]
    got = port.module.state_dict()
    want = variables_to_state_dict(jmodel.variables)
    prefix = f'backbones.{backbone}.features.'      # not the FPN's
    keys = [k for k in got if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(k for k in want
                                           if k.startswith(prefix))
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k, v in _weights(backbone, sd).items():
        assert torch.equal(got[k], v), k


def _donor(tmp_path):
    path = str(tmp_path / 'donor.pth')
    Model('ResNet18FPN', classes=3).initialize(
        torch.Generator().manual_seed(4)).save({'path': path})
    return path


@pytest.mark.parametrize('flags,source', [
    ([], 'zoo'), (['--no-pretrained'], 'random'),
    (['--fine-tune', 'DONOR'], 'donor'),
    (['--backbone-weights', 'OTHER'], 'other'),
    (['--backbone-weights', 'OTHER', '--no-pretrained'], 'other')])
def test_cli_precedence_matches_jax(tmp_path, monkeypatch, flags, source):
    """A fresh model from each package's ``load_model`` with the zoo file
    in ``ODTK_WEIGHTS_DIR``: the file by default; ``--no-pretrained``,
    ``--fine-tune`` and ``--backbone-weights`` each skip it, the last
    winning, in both packages alike."""
    d, zoo_sd = _zoo_dir(tmp_path, 'ResNet18FPN', seed=3)
    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(d))
    other = str(tmp_path / 'other.pth')
    other_sd = _torchvision_sd('ResNet18FPN', seed=9)
    torch.save(other_sd, other)
    donor = _donor(tmp_path)
    flags = [{'DONOR': donor, 'OTHER': other}.get(f, f) for f in flags]
    argv = ['train', str(tmp_path / 'new.pth'), '--annotations', 'a.json',
            '--backbone', 'ResNet18FPN', '--classes', '3'] + flags
    random.seed(0)
    port, _ = cli.load_model(cli.parse(argv))
    jmodel, _ = jax_main.load_model(jax_main.parse(argv))
    got = port.module.state_dict()
    jax_sd = variables_to_state_dict(jmodel.variables)
    donor_sd = torch.load(donor, weights_only=True)['state_dict']
    want = {'zoo': _weights('ResNet18FPN', zoo_sd),
            'other': _weights('ResNet18FPN', other_sd)}.get(source)
    for k, v in _weights('ResNet18FPN', zoo_sd).items():
        is_zoo = torch.equal(got[k], v)
        assert is_zoo == (source == 'zoo'), k
        assert np.array_equal(np.asarray(jax_sd[k]), v.numpy()) == is_zoo, k
        if want is not None:
            assert torch.equal(got[k], want[k]), k
            np.testing.assert_array_equal(np.asarray(jax_sd[k]),
                                          want[k].numpy(), err_msg=k)
        if source == 'donor':
            assert torch.equal(got[k], donor_sd[k]), k
            np.testing.assert_array_equal(np.asarray(jax_sd[k]),
                                          donor_sd[k].numpy(), err_msg=k)


def test_download_renames_a_per_process_part(tmp_path, monkeypatch):
    """A miss downloads (``urlopen`` serves bytes from memory here) into
    ``<file>.<pid>.part`` in the first cache directory and renames it
    into place; a failed download removes its part."""
    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(tmp_path / 'w'))
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'th'))
    payload = bytes(range(256)) * 4097

    class Response(io.BytesIO):
        pass

    urls = []

    def serve(url, timeout):
        urls.append((url, timeout))
        return Response(payload)
    monkeypatch.setattr('urllib.request.urlopen', serve)
    renames = []
    replace = os.replace

    def record(src, dst):
        renames.append((src, dst, os.path.getsize(src)))
        replace(src, dst)
    monkeypatch.setattr(os, 'replace', record)
    path = model_zoo.fetch('ResNet18FPN', timeout=3.0)
    part = str(tmp_path / 'w' / f'{R18}.{os.getpid()}.part')
    assert path == str(tmp_path / 'w' / R18)
    assert model_zoo.part_path(str(tmp_path / 'w'), R18) == part
    assert urls == [(model_zoo.ZOO_URLS['ResNet18FPN'], 3.0)]
    assert renames == [(part, path, len(payload))]
    with open(path, 'rb') as f:
        assert f.read() == payload
    assert os.listdir(tmp_path / 'w') == [R18]

    def cut(url, timeout):
        class Broken(io.BytesIO):
            def read(self, n=-1):
                raise OSError('connection reset')
        return Broken()
    monkeypatch.setattr('urllib.request.urlopen', cut)
    assert model_zoo.fetch('ResNet50FPN') is None
    assert os.listdir(tmp_path / 'w') == [R18]
    assert model_zoo._OFFLINE[0]


_CLI_RUN = r'''
import json, sys, urllib.request
def refuse(*a, **k):
    raise AssertionError('network touched')
urllib.request.urlopen = refuse
sys.path.insert(0, {tests!r})
from synth import make_dataset
from odtk_tpu_torch import main as cli
img, ann = make_dataset({root!r}, n_images=2, size=(64, 96), fmt='jpg')
out = cli.main(['train', {ckpt!r}, '--images', img, '--annotations', ann,
                '--backbone', 'ResNet18FPN', '--classes', '3', '--batch', '2',
                '--resize', '64', '--max-size', '96', '--jitter', '64', '64',
                '--iters', '1', '--warmup', '1', '--milestones', '100',
                '--lr', '0', '--full-precision', '--device', 'cpu'])
print(json.dumps(out['losses']))
'''


def test_cli_train_default_init_equals_jax(tmp_path, monkeypatch):
    """``python -m odtk_tpu_torch.main train`` of a fresh model with the
    zoo file in ``ODTK_WEIGHTS_DIR`` (one step at lr 0, which leaves the
    weights as they were): the written backbone equals the file and the
    JAX CLI's ``load_model`` from the same file, bit for bit."""
    d, sd = _zoo_dir(tmp_path, 'ResNet18FPN', seed=21)
    ckpt = str(tmp_path / 'model.pth')
    code = _CLI_RUN.format(tests=os.path.join(REPO, 'tests'),
                           root=str(tmp_path), ckpt=ckpt)
    env = dict(os.environ, PYTHONPATH=REPO, ODTK_WEIGHTS_DIR=str(d),
               **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f'Initializing ResNet18FPN from ImageNet weights ({d / R18})' \
        in out.stdout
    losses = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(losses) == 1 and np.isfinite(losses).all()
    saved = Model.load(ckpt)[0].module.state_dict()

    monkeypatch.setenv('ODTK_WEIGHTS_DIR', str(d))
    jmodel, _ = jax_main.load_model(jax_main.parse(
        ['train', str(tmp_path / 'jax.pth'), '--annotations', 'a.json',
         '--backbone', 'ResNet18FPN', '--classes', '3']))
    jax_sd = variables_to_state_dict(jmodel.variables)
    for k, v in _weights('ResNet18FPN', sd).items():
        assert torch.equal(saved[k], v), k
        np.testing.assert_array_equal(np.asarray(jax_sd[k]), v.numpy(),
                                      err_msg=k)
