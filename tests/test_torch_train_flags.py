"""The train CLI's file flags in odtk_tpu_torch against the JAX package
and its libraries, on the CPU: ``--backbone-weights``
(``io/torch_import.py``), ``--logdir`` (``io/events.py`` against
tensorboardX, read back by tensorboard's loader), ``--post-metrics``
(``utils.post_metrics`` against the JAX package's ``requests`` version,
both posting to a local ``http.server``) and ``--profile-dir``.
"""

import glob
import http.server
import json
import os
import random
import re
import socket
import struct
import threading
import urllib.parse
import warnings

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import \
    EventFileLoader
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import \
    masked_crc32c

from odtk_tpu import utils as jax_utils
from odtk_tpu.io.torch_import import load_backbone_weights as jax_load
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import main as cli
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch import utils
from odtk_tpu_torch.io import events
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.io.torch_import import load_backbone_weights
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
# torchvision's classifier of each network, which both loaders drop
CLASSIFIERS = {'ResNet18FPN': {'fc.weight': (1000, 512), 'fc.bias': (1000,)},
               'MobileNetV2FPN': {'classifier.1.weight': (1000, 1280),
                                  'classifier.1.bias': (1000,)}}


def _torchvision_file(path, variables, name, seed, extra=()):
    """A seeded torchvision-format state_dict of backbone ``name``: its
    features' keys without the ``backbones.<name>.features.`` prefix, a
    ``num_batches_tracked`` for every batch norm and the classifier head,
    wrapped in a ``state_dict`` entry. ``extra``: (key, shape) to add."""
    rng = np.random.default_rng(seed)
    prefix = f'backbones.{name}.features.'
    sd = {}
    for k, v in variables_to_state_dict(variables).items():
        if k.startswith(prefix):
            sd[k[len(prefix):]] = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
            if k.endswith('.running_var'):
                sd[k[len(prefix):]].abs_()
                sd[k[len(prefix):-len('running_var')]
                   + 'num_batches_tracked'] = torch.tensor(5)
    for k, shape in list(CLASSIFIERS.get(name, {}).items()) + list(extra):
        sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    torch.save({'state_dict': sd}, path)
    return sd


def _both(name, seed=0):
    """The JAX model and the port's with the same initial weights."""
    jmodel = JaxModel(name, classes=CLASSES)
    jmodel.initialize(rng=seed, image_size=(128, 128))
    port = Model(name, classes=CLASSES)
    port.module.load_state_dict(state_dict_from_jax(jmodel.variables),
                                strict=True)
    return jmodel, port


@pytest.mark.parametrize('name', ['ResNet18FPN', 'MobileNetV2FPN'])
def test_backbone_weights_match_jax(tmp_path, name):
    """The same torchvision-format file into the same model: every tensor
    of the two models equal bit for bit, the backbone's the file's."""
    jmodel, port = _both(name)
    path = str(tmp_path / f'{name}.pth')
    sd = _torchvision_file(path, jmodel.variables, name, seed=1)
    jax_load(jmodel, name, path)
    filled = load_backbone_weights(port, name, path)
    want = variables_to_state_dict(jmodel.variables)
    got = port.module.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    prefix = f'backbones.{name}.features.'
    assert filled == sorted(prefix + k for k in sd
                            if k not in CLASSIFIERS[name]
                            and not k.endswith('num_batches_tracked'))
    assert torch.equal(got[prefix + 'conv1.weight' if name == 'ResNet18FPN'
                           else prefix + 'features.0.0.weight'],
                       sd['conv1.weight' if name == 'ResNet18FPN'
                          else 'features.0.0.weight'])


def test_c4_refuses_a_full_resnet18_file_as_jax_does(tmp_path):
    """ResNet18C4 builds no ``layer4`` in either package, so a full
    resnet18 file is refused by both, with the same message."""
    full, _ = _both('ResNet18FPN')
    jmodel, port = _both('ResNet18C4')
    path = str(tmp_path / 'resnet18.pth')
    sd = _torchvision_file(path, full.variables, 'ResNet18FPN', seed=0)
    assert any(k.startswith('layer4.') for k in sd)
    with pytest.raises(ValueError) as want:
        jax_load(jmodel, 'ResNet18C4', path)
    with pytest.raises(ValueError) as got:
        load_backbone_weights(port, 'ResNet18C4', path)
    assert str(got.value) == str(want.value)
    assert "'layer4_0'" in str(got.value)


def test_unmatched_and_misshapen_tensors_raise_as_in_jax(tmp_path):
    """A key that matches nothing, and one of another shape: both
    packages raise with the same message, and leave the model as it
    was."""
    jmodel, port = _both('ResNet18FPN')
    path = str(tmp_path / 'bad.pth')
    sd = _torchvision_file(path, jmodel.variables, 'ResNet18FPN', seed=2,
                           extra=[('layer9.0.conv1.weight', (8, 8, 3, 3))])
    sd['layer1.0.conv1.weight'] = torch.zeros(64, 64, 1, 1)
    torch.save(sd, path)
    before = {k: v.clone() for k, v in port.module.state_dict().items()}
    with pytest.raises(ValueError) as want:
        jax_load(jmodel, 'ResNet18FPN', path)
    with pytest.raises(ValueError) as got:
        load_backbone_weights(port, 'ResNet18FPN', path)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith('2 tensors in ')
    for k, v in port.module.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ event files
def _scalars(log_dir):
    """(path, [(tag, step, value), ...]) of the one event file in
    ``log_dir``; the loader hands a simple_value over as a tensor."""
    (path,) = glob.glob(os.path.join(log_dir, 'events.out.tfevents.*'))
    out = []
    for event in EventFileLoader(path).Load():
        for value in event.summary.value:
            (number,) = value.tensor.float_val
            out.append((value.tag, event.step, number))
    return path, out


def test_crc32c_known_vector():
    assert events.crc32c(b'123456789') == 0xE3069283
    assert events.crc32c(b'') == 0


def test_event_file_reads_back_as_tensorboardx_writes_it(tmp_path):
    """The same add_scalar calls through the port's writer and through
    tensorboardX's: tensorboard's loader reads the same (tag, step,
    value) list from both files; every record's two CRCs check."""
    from tensorboardX import SummaryWriter as XWriter

    calls = [('focal_loss', 1.25, 10), ('box_loss', 0.5, 10),
             ('learning_rate', 1e-3, 10), ('focal_loss', 0.75, 0),
             ('Validation_Precision/mAP (small)', -1.0, 2 ** 40)]
    for cls, sub in ((events.SummaryWriter, 'port'), (XWriter, 'x')):
        writer = cls(str(tmp_path / sub))
        for tag, value, step in calls:
            writer.add_scalar(tag, value, step)
        writer.flush()
        writer.close()
    path, got = _scalars(str(tmp_path / 'port'))
    _, want = _scalars(str(tmp_path / 'x'))
    assert got == want
    assert [(s, v) for _, s, v in got] == [(s, float(np.float32(v)))
                                          for _, v, s in calls]
    assert got[-1][0] == 'Validation_Precision/mAP__small_'  # cleaned
    assert os.path.basename(path).startswith('events.out.tfevents.')
    with open(path, 'rb') as f:
        data = f.read()
    pos, records = 0, 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack('<Q', header)
        (crc,) = struct.unpack('<I', data[pos + 8:pos + 12])
        body = data[pos + 12:pos + 12 + length]
        (body_crc,) = struct.unpack('<I', data[pos + 12 + length:
                                               pos + 16 + length])
        assert crc == masked_crc32c(header)
        assert body_crc == masked_crc32c(body)
        pos += 16 + length
        records += 1
    assert records == len(calls) + 1          # the file_version event
    first = next(iter(EventFileLoader(path).Load()))
    assert first.file_version == 'brain.Event:2'


# ---------------------------------------------------------------- metrics
class _Collector(http.server.BaseHTTPRequestHandler):
    posts = []

    def do_POST(self):       # noqa: N802 (http.server's name)
        body = self.rfile.read(int(self.headers['Content-Length']))
        self.posts.append((self.headers['Content-Type'],
                           urllib.parse.parse_qs(body.decode())))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def collector():
    _Collector.posts = []
    server = http.server.HTTPServer(('127.0.0.1', 0), _Collector)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f'http://127.0.0.1:{server.server_address[1]}/', _Collector.posts
    server.shutdown()
    server.server_close()


def _batches(posts):
    """[(time, [(metric, value), ...]), ...] per distinct timestamp."""
    out = {}
    for ctype, fields in posts:
        assert ctype == 'application/x-www-form-urlencoded'
        assert set(fields) == {'time', 'metric', 'value'}
        out.setdefault(fields['time'][0], []).append(
            (fields['metric'][0], fields['value'][0]))
    return list(out.items())


def test_post_metrics_posts_what_jax_posts(collector):
    """Form-encoded time / metric / value, one POST a metric, one time a
    batch, the same fields as the JAX package's ``requests`` version."""
    url, posts = collector
    metrics = {'focal loss': 1.0986, 'box loss': 0.25, 'im_s': 12.5,
               'lr': 0.001}
    utils.post_metrics(url, metrics)
    port = _batches(posts)
    del posts[:]
    jax_utils.post_metrics(url, metrics)
    jax = _batches(posts)
    assert len(port) == len(jax) == 1
    assert port[0][1] == jax[0][1] == [(k, str(v))
                                       for k, v in metrics.items()]
    assert int(port[0][0]) > 0


def test_post_metrics_refused_connection_warns():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    with pytest.warns(UserWarning, match='posting metrics to .* failed'):
        utils.post_metrics(f'http://127.0.0.1:{port}/', {'lr': 0.1})


# -------------------------------------------------------------------- CLI
def _cli_args(tmp_path, ckpt, iters):
    img, ann = make_dataset(str(tmp_path), n_images=4, size=(64, 96),
                            fmt='jpg')
    return ['train', ckpt, '--images', img, '--annotations', ann,
            '--backbone', 'ResNet18FPN', '--classes', '3', '--batch', '2',
            '--resize', '64', '--max-size', '96', '--jitter', '64', '64',
            '--iters', str(iters), '--warmup', '1', '--milestones', '100',
            '--full-precision', '--device', 'cpu', '--no-pretrained']


def test_cli_profile_dir_logdir_post_metrics(tmp_path, collector):
    """``train --profile-dir --logdir --post-metrics`` on the CPU for 11
    iterations: the run ends inside the trace's window (10 to 20), so the
    trace closes at the loop's end and parses as JSON; each log block
    (one at iteration 11, and one every 60 s before it on a slow host)
    writes the three scalars with the mean losses of its iterations and
    posts the four keys at one time."""
    url, posts = collector
    ckpt = str(tmp_path / 'model.pth')
    random.seed(0)
    out = cli.main(_cli_args(tmp_path, ckpt, 11) + [
        '--profile-dir', str(tmp_path / 'trace'),
        '--logdir', str(tmp_path / 'logs'), '--post-metrics', url])
    assert os.path.dirname(out['trace']) == str(tmp_path / 'trace')
    assert os.path.basename(out['trace']) == 'train_iterations_10-10.json'
    with open(out['trace']) as f:
        trace = json.load(f)
    assert trace['traceEvents']
    _, scalars = _scalars(str(tmp_path / 'logs'))
    blocks = [scalars[i:i + 3] for i in range(0, len(scalars), 3)]
    assert blocks and blocks[-1][0][1] == 11
    begin = 0
    for block in blocks:
        end = block[0][1]
        assert [(t, s) for t, s, _ in block] == [
            ('focal_loss', end), ('box_loss', end), ('learning_rate', end)]
        losses = [(c, b) for it, c, b in out['losses'] if begin <= it < end]
        np.testing.assert_allclose(
            [v for _, _, v in block],
            list(np.mean(losses, axis=0)) + [0.01], rtol=1e-6)
        begin = end
    batches = _batches(posts)
    assert len(batches) == len(blocks)
    for _, fields in batches:
        assert [k for k, _ in fields] == ['focal loss', 'box loss', 'im_s',
                                          'lr']


def test_validation_writes_twelve_scalars(tmp_path):
    """A validation run writes the twelve ``Validation_*`` scalars at its
    iteration, after the log block's three, with the COCO stats of the
    run (tags cleaned as tensorboardX cleans them). The model's score
    threshold is lowered so that its random weights detect something."""
    img, ann = make_dataset(str(tmp_path), n_images=4, size=(64, 96),
                            fmt='jpg')
    model = Model('ResNet18FPN', classes=CLASSES).initialize(0)
    model.threshold = 0.001
    out = port_train.train(
        model, {'path': str(tmp_path / 'model.pth')}, img, ann, img, ann, 64,
        96, [64, 64], 2, 1, 100, 0.01, 0, [], 0.1, mixed_precision=False,
        verbose=False, logdir=str(tmp_path / 'logs'), device='cpu')
    _, scalars = _scalars(str(tmp_path / 'logs'))
    assert [(t, s) for t, s, _ in scalars] == \
        [('focal_loss', 1), ('box_loss', 1), ('learning_rate', 1)] + [
            (re.sub(r'[^-/\w.]', '_', t), 1)
            for t in port_train.VALIDATION_TAGS]
    stats = port_train.infer(
        out['model'], img, None, 64, 96, 2, annotations=ann,
        mixed_precision=False, verbose=False, device='cpu')['stats']
    np.testing.assert_allclose([v for _, _, v in scalars[3:]], stats,
                               rtol=1e-6)


def test_cli_backbone_weights_one_step(tmp_path):
    """``train --backbone-weights`` on a fresh model runs a step; at lr 0
    the step moves no weight, so the checkpoint's backbone is the
    file's."""
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES)
    jmodel.initialize(rng=0, image_size=(128, 128))
    weights = str(tmp_path / 'resnet18.pth')
    sd = _torchvision_file(weights, jmodel.variables, 'ResNet18FPN', seed=3)
    ckpt = str(tmp_path / 'model.ckpt')
    random.seed(0)
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)
        out = cli.main(_cli_args(tmp_path, ckpt, 1) + [
            '--backbone-weights', weights, '--lr', '0'])
    assert len(out['losses']) == 1 and np.isfinite(out['losses'][0]).all()
    saved = Model.load(ckpt)[0].module.state_dict()
    prefix = 'backbones.ResNet18FPN.features.'
    for k, v in sd.items():
        if k in CLASSIFIERS['ResNet18FPN'] or k.endswith('batches_tracked'):
            continue
        assert torch.equal(saved[prefix + k], v), k
