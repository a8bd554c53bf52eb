"""odtk_tpu_torch's export path held against the JAX package on the CPU:
the fp32 engine against JAX's fp32 ``Engine`` on the same weights, the
engine against the port's own checkpoint inference, the custom operators
in the exported graph, and the behaviour of ``tests/test_engine.py``
(profile padding, chunking, bad magic, stride rounding, baked overrides,
the rotated round trip), plus the CLI ``export`` -> ``infer`` in a
process that loads nothing of JAX.

One JAX ResNet18FPN model (3 classes) per module, its final head kernels
redrawn by numpy so that the logits spread over several units (at the
0.01 init every score sits near the prior and conv-order noise would
reorder near-ties); the port gets its weights through the weight bridge.
Everything runs in fp32 on the CPU. Each test states its tolerance.
"""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from odtk_tpu.export import Engine as JaxEngine
from odtk_tpu.export import export_model as jax_export_model
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.export import (ENGINE_HEADER, Engine, export_model,
                                   load_cpp_engine)
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.model import Model
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {'threshold': 0.001, 'detections': 20}


def spread_variables(seed=0, classes=3):
    """ResNet18FPN JAX variables with the final cls / box head kernels
    drawn at std 1.0 / 0.2."""
    model = JaxModel('ResNet18FPN', classes=classes)
    model.initialize(rng=0, image_size=(128, 128))
    variables = jax.tree.map(np.asarray, model.variables)
    rng = np.random.RandomState(seed)
    params = dict(variables['params'])
    for name, std in (('cls_head_8', 1.0), ('box_head_8', 0.2)):
        kernel = params[name]['kernel']
        params[name] = dict(params[name], kernel=(
            rng.randn(*kernel.shape) * std).astype(np.float32))
    return dict(variables, params=params)


def port_model(variables, config=CONFIG, classes=3):
    model = Model('ResNet18FPN', classes=classes, config=config)
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def images(b, seed=0, size=128):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, size, size, 3) * 0.5).astype(np.float32)


@pytest.fixture(scope='module')
def variables():
    return spread_variables()


@pytest.fixture(scope='module')
def engine(variables, tmp_path_factory):
    """The port's fp32 engine at 128x128 with profiles 1 and 2, loaded
    back from its file, and the model it came from."""
    model = port_model(variables)
    path = str(tmp_path_factory.mktemp('engine') / 'm.engine')
    export_model(model, (128, 128), precision='fp32', path=path,
                 dynamic_batch_opts=[1, 2, 2])
    return Engine.load(path), model


def graph_code(engine, batch):
    """The Python code of one profile's program, its autocast regions
    included."""
    program = torch.export.load(io.BytesIO(engine.blobs[str(batch)]))
    return '\n'.join(m.code for m in program.graph_module.modules()
                     if hasattr(m, 'code'))


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


def test_engine_metadata(engine):
    eng, _ = engine
    assert eng.input_size == (128, 128)
    assert eng.max_batch == 2 and eng.meta['batches'] == [1, 2]
    assert eng.max_detections == 20 and eng.stride == 128
    assert eng.meta['device'] == 'cpu' and eng.meta['precision'] == 'fp32'
    assert not eng.rotated_bbox
    assert eng.meta['postprocessing']['threshold'] == 0.001


def test_engine_matches_jax_engine(variables, engine, tmp_path):
    """The port's fp32 engine against the JAX package's fp32 Engine on the
    same weights and image: the same detections (matched by class and
    score), scores within 1e-5, boxes within 1e-3 px (the convolutions sum
    in another order)."""
    jmodel = JaxModel('ResNet18FPN', classes=3, config=CONFIG)
    jmodel.variables = variables
    path = str(tmp_path / 'jax.engine')
    jax_export_model(jmodel, (128, 128), precision='fp32', path=path,
                     dynamic_batch_opts=[1, 1, 1])
    x = images(1, seed=3)
    want = JaxEngine.load(path)(x)
    got = engine[0](x)
    g = _by_class_score(*(t[0].numpy() for t in got))
    w = _by_class_score(*(np.asarray(t[0]) for t in want))
    assert len(g[0]) == len(w[0]) > 5
    np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-3)


def test_engine_equals_checkpoint_inference(engine):
    """The engine runs the checkpoint path's operations: equal to
    ``Model.inference_fn`` within 1e-6."""
    eng, model = engine
    x = torch.from_numpy(images(2, seed=1))
    got = eng(x)
    want = model.inference_fn(x)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert (got[0] > 0).sum() > 5


def test_exported_graph_holds_the_kernel_operators(engine):
    """The programs keep the hand-written kernels as odtk:: operators (on
    the CPU their plain versions run behind them), and hold no weights."""
    eng, _ = engine
    code = graph_code(eng, 1)
    assert 'torch.ops.odtk.nms.default' in code
    assert 'torch.ops.odtk.bn_relu_pool.default' in code
    assert 'nms_rotated' not in code
    assert len(torch.export.load(io.BytesIO(eng.blobs['1'])).state_dict) == 0


def test_engine_pads_to_profile(engine):
    eng, _ = engine
    one = images(1, seed=2)
    two = np.concatenate([one, np.zeros_like(one)])
    s1 = eng(one)[0]
    s2 = eng(two)[0]
    assert s1.shape == (1, 20) and s2.shape == (2, 20)
    torch.testing.assert_close(s2[0], s1[0], rtol=0, atol=1e-5)


def test_engine_chunks_oversized_batch(engine):
    """Batch 5 over a largest profile of 2 runs in chunks of 2."""
    eng, _ = engine
    x = images(5, seed=4)
    s, b, c = eng(x)
    assert s.shape[0] == b.shape[0] == c.shape[0] == 5
    s1, b1, _ = eng(x[3:4])
    torch.testing.assert_close(s[3], s1[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(b[3], b1[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize('where', ['header', 'magic'])
def test_engine_rejects_bad_magic(tmp_path, engine, where):
    path = tmp_path / 'junk.engine'
    if where == 'header':
        path.write_bytes(b'not an engine at all')
    else:
        meta = json.dumps(dict(engine[0].meta, magic='other')).encode()
        path.write_bytes(ENGINE_HEADER + len(meta).to_bytes(8, 'little')
                         + meta)
    with pytest.raises(ValueError, match='not an odtk-tpu-torch engine'):
        Engine.load(str(path))


def test_engine_runs_on_its_export_device_only(engine, tmp_path,
                                               monkeypatch):
    """A CPU engine refuses a CUDA device, and a CUDA engine refuses to
    load where there is no card."""
    eng, _ = engine
    path = str(tmp_path / 'm.engine')
    eng.save(path)
    with pytest.raises(ValueError, match='exported on cpu'):
        Engine.load(path, device='cuda')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Engine(dict(eng.meta, device='cuda'), eng.blobs, eng.variables)


def test_export_rounds_size_to_stride(variables, tmp_path):
    """An unaligned size rounds up to the stride (the loader pads every
    image to stride multiples), and a smaller input is padded into it."""
    path = str(tmp_path / 'odd.engine')
    export_model(port_model(variables), (100, 100), precision='fp32',
                 path=path, dynamic_batch_opts=[1, 1, 1])
    eng = Engine.load(path)
    assert eng.input_size == (128, 128)
    out = eng(np.random.RandomState(0).randn(1, 96, 80, 3)
              .astype(np.float32))
    assert out[0].shape == (1, 20)


def test_export_postprocessing_overrides(tmp_path):
    """The CLI bakes threshold / top-n / nms / detections into the engine."""
    ckpt = str(tmp_path / 'm.pth')
    Model('ResNet18FPN', classes=3).initialize(0).save({'path': ckpt})
    path = str(tmp_path / 'm.engine')
    cli.main(['export', ckpt, path, '--size', '128', '--full-precision',
              '--dynamic-batch-opts', '1', '1', '1', '--detections', '25',
              '--top-n', '200', '--threshold', '0.1', '--nms', '0.4',
              '--device', 'cpu'])
    eng = Engine.load(path)
    assert eng.max_detections == 25
    assert eng.meta['postprocessing'] == {
        'threshold': 0.1, 'top_n': 200, 'nms': 0.4, 'fused_top_n': 400,
        'decode_fused': True}
    assert 'odtk.nms.default(' in graph_code(eng, 1)
    out = eng(images(1))
    assert out[0].shape == (1, 25) and out[1].shape == (1, 25, 4)


@pytest.mark.parametrize('ext', ['.stablehlo', '.cppengine'])
def test_unported_targets_name_their_roadmap_item(variables, tmp_path, ext):
    """The two targets that ROADMAP Queue 1 item 8 ported: ``.stablehlo``
    (XLA's format) is refused in favour of ``.pt2``, and the CLI writes a
    ``.cppengine`` at the batch of ``--dynamic-batch-opts``' middle value
    whose metadata states its contract."""
    path = str(tmp_path / f'm{ext}')
    if ext == '.stablehlo':
        with pytest.raises(ValueError, match=r'write a \.pt2'):
            export_model(port_model(variables), (128, 128), path=path)
        return
    ckpt = str(tmp_path / 'm.pth')
    port_model(variables).save({'path': ckpt})
    cli.main(['export', ckpt, path, '--size', '128', '--input-format', 'u8',
              '--dynamic-batch-opts', '1', '3', '4', '--device', 'cpu'])
    meta = load_cpp_engine(path).get_metadata()
    assert (meta['batch'], meta['input'], meta['precision'],
            meta['height'], meta['box_dim']) == ('3', 'u8', 'FP16', '128',
                                                 '4')


def test_rotated_engine_roundtrip(tmp_path):
    """A rotated model exports with the rotated NMS operator, returns
    6-wide boxes, and equals its checkpoint inference within 1e-6."""
    model = Model('ResNet18FPN', classes=3, rotated_bbox=True,
                  config=CONFIG).initialize(0)
    path = str(tmp_path / 'rot.engine')
    export_model(model, (128, 128), precision='fp32', path=path,
                 dynamic_batch_opts=[1, 1, 1])
    eng = Engine.load(path)
    assert eng.rotated_bbox
    assert 'torch.ops.odtk.nms_rotated.default' in graph_code(eng, 1)
    x = torch.from_numpy(images(1, seed=5))
    got = eng(x)
    want = model.inference_fn(x)
    assert got[1].shape == (1, 20, 6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


_CLI_RUN = '''
import json, sys
sys.path.insert(0, {tests!r})
before = set(sys.modules)
from synth import make_dataset
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.model import Model
img, ann = make_dataset({root!r}, n_images=4, size=(100, 120), max_boxes=2,
                        seed=5, fmt='jpg')
Model('ResNet18FPN', classes=3).initialize(0).save({{'path': {ckpt!r}}})
cli.main(['export', {ckpt!r}, {engine!r}, '--size', '128', '--int8',
          '--calibration-images', img, '--calibration-batches', '1',
          '--dynamic-batch-opts', '1', '2', '2', '--threshold', '0.001',
          '--calibration-table', {table!r}, '--device', 'cpu'])
r = cli.main(['infer', {engine!r}, '--images', img, '--annotations', ann,
              '--batch', '2', '--device', 'cpu', '--output', {det!r}])
mods = {{m.split('.')[0] for m in set(sys.modules) - before}}
print(json.dumps({{'stats': None if r['stats'] is None else
                   [float(v) for v in r['stats']],
                   'leaked': sorted(mods & {{'jax', 'jaxlib', 'odtk_tpu',
                                            'flax', 'optax'}})}}))
'''


def test_cli_export_then_infer_without_jax(tmp_path):
    """``export --int8`` (absmax calibration on two JPEGs) then ``infer``
    on the engine, on the CPU, in a process that imports nothing of JAX
    or of the JAX package: a calibration table, finite detections and
    COCO stats."""
    ckpt, engine_path = str(tmp_path / 'm.pth'), str(tmp_path / 'm.engine')
    det, table = str(tmp_path / 'det.json'), str(tmp_path / 'table.json')
    code = _CLI_RUN.format(tests=os.path.join(REPO, 'tests'),
                           root=str(tmp_path), ckpt=ckpt, engine=engine_path,
                           det=det, table=table)
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'precision: INT8' in out.stdout and 'engine' in out.stdout
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report['leaked'] == []
    assert report['stats'] is not None and len(report['stats']) == 12
    with open(table) as f:
        assert json.load(f)['method'] == 'absmax'
    with open(det) as f:
        dets = json.load(f)['annotations']
    assert dets
    for d in dets:
        assert len(d['bbox']) == 4 and np.isfinite(d['bbox']).all()
        assert 0.001 < d['score'] < 1
