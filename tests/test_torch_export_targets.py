"""The port's last two export targets held against its ``.engine`` and the
JAX package on the CPU: the ``.cppengine`` (an AOTInductor package,
``export_cpp_engine``) and the ``.pt2`` (``torch.export`` program) in
place of ``.stablehlo``.

One fp32 ResNet18FPN ``.cppengine`` at 128 px, batch 2, on the f32
contract, compiled once for the module (the compile takes most of the
file's time), from the JAX model's numpy weights through the weight
bridge, with the final head kernels spread as in
``tests/test_torch_export.py``.
"""

import json
import os
import struct
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from odtk_tpu.export import export_cpp_engine as jax_export_cpp_engine
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.export import (Engine, export_cpp_engine, export_model,
                                   load_cpp_engine)
from test_torch_export import CONFIG, images, port_model, spread_variables
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def variables():
    return spread_variables()


@pytest.fixture(scope='module')
def targets(variables, tmp_path_factory):
    """(the fp32 .cppengine at batch 2 loaded back, its path, the .engine
    of the same weights with profiles 1 and 2, its checkpoint)."""
    root = tmp_path_factory.mktemp('targets')
    ckpt = str(root / 'm.pth')
    port_model(variables).save({'path': ckpt})
    path = str(root / 'm.cppengine')
    export_cpp_engine(port_model(variables), (128, 128), batch=2, path=path,
                      precision='fp32', input_format='f32')
    engine = export_model(port_model(variables), (128, 128),
                          precision='fp32', dynamic_batch_opts=[1, 2, 2])
    return load_cpp_engine(path), path, engine, ckpt


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


def test_cppengine_equals_engine(targets):
    """The package runs the ``.engine``'s operations: scores within 1e-5,
    classes equal, boxes (flattened to [B, D * 4]) within 1e-3 px, the
    tolerance of ``test_engine_matches_jax_engine``. The package's
    convolutions are AOTInductor's oneDNN calls on prepacked weights,
    which sum in another order than the eager ones: on one thread the
    boxes differ by up to 9.5e-5 px (a relative 7e-6)."""
    package, _, engine, _ = targets
    x = torch.from_numpy(images(2, seed=1))
    got = package(x)
    want = engine(x)
    assert got[1].shape == (2, 20 * 4)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], want[1].reshape(2, -1), rtol=0,
                               atol=1e-3)
    assert torch.equal(got[2], want[2])
    assert (got[0] > 0).sum() > 5


def test_cppengine_matches_jax_inference(variables, targets):
    """The package against the JAX model's ``inference_fn`` on the same
    numpy weights and images, with ``test_engine_matches_jax_engine``'s
    tolerance: the same detections matched by (class, score), scores
    within 1e-5, boxes within 1e-3 px."""
    package = targets[0]
    jmodel = JaxModel('ResNet18FPN', classes=3, config=CONFIG)
    x = images(2, seed=3)
    want = jax.jit(jmodel.inference_fn)(variables, x)
    got = package(torch.from_numpy(x))
    for i in range(2):
        g = _by_class_score(got[0][i].numpy(),
                            got[1][i].reshape(-1, 4).numpy(),
                            got[2][i].numpy())
        w = _by_class_score(*(np.asarray(t[i]) for t in want))
        assert len(g[0]) == len(w[0]) > 5
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-3)


def test_cppengine_metadata_is_the_jax_containers(variables, targets,
                                                  tmp_path):
    """The package's metadata holds the keys and values of the JAX
    ``export_cpp_engine`` container of the same model (the JSON block
    after ``ODTKCPP1``), as strings, plus the device."""
    package = targets[0]
    jmodel = JaxModel('ResNet18FPN', classes=3, config=CONFIG)
    jmodel.variables = variables
    path = str(tmp_path / 'jax.cppengine')
    jax_export_cpp_engine(jmodel, (128, 128), batch=2, path=path,
                          precision='fp32', platform='cpu')
    with open(path, 'rb') as f:
        assert f.read(8) == b'ODTKCPP1'
        (n,) = struct.unpack('<I', f.read(4))
        jax_meta = json.loads(f.read(n))
    meta = package.get_metadata()
    assert {k: meta[k] for k in jax_meta} == {
        k: str(v) for k, v in jax_meta.items()}
    assert meta['device'] == 'cpu'


def test_cppengine_keeps_the_kernel_operators(targets):
    """AOTInductor compiled the rest of the graph, and the hand-written
    kernels stay ``odtk::`` operators that the compiled code calls
    through the proxy executor (the package's extern-node table)."""
    path = targets[1]
    with zipfile.ZipFile(path) as z:
        [table] = [n for n in z.namelist() if n.endswith('wrapper.json')]
        nodes = json.loads(z.read(table))['nodes']
        [source] = [n for n in z.namelist() if n.endswith('wrapper.cpp')]
        code = z.read(source).decode()
    assert sorted(n['node']['target'] for n in nodes) == [
        'odtk::bn_relu_pool', 'odtk::nms']
    assert code.count('aoti_torch_proxy_executor_call_function(') == 2


def test_cppengine_refuses_int8(targets, tmp_path):
    """``export --int8`` to a ``.cppengine`` raises: the C++ engine is
    fp32 or bf16."""
    with pytest.raises(ValueError, match='INT8 .cppengine'):
        cli.main(['export', targets[3], str(tmp_path / 'q.cppengine'),
                  '--size', '128', '--int8', '--device', 'cpu'])
    assert not os.path.exists(tmp_path / 'q.cppengine')


def test_stablehlo_is_refused_naming_pt2(targets, tmp_path):
    with pytest.raises(ValueError, match=r'\.pt2'):
        cli.main(['export', targets[3], str(tmp_path / 'm.stablehlo'),
                  '--size', '128', '--device', 'cpu'])


_PT2_RUN = '''
import sys
sys.modules['jax'] = None          # importing JAX fails in this process
import numpy as np
import torch
import odtk_tpu_torch.export  # noqa: F401  (the odtk:: operators)
program = torch.export.load({pt2!r})
code = '\\n'.join(m.code for m in program.graph_module.modules()
                 if hasattr(m, 'code'))
x = torch.from_numpy(np.load({x!r}))
with torch.no_grad():
    out = program.module()(x)
np.savez({out!r}, *[o.numpy() for o in out])
leaked = sorted({{m.split('.')[0] for m in sys.modules}}
                & {{'jaxlib', 'odtk_tpu', 'flax', 'optax'}})
print('odtk.nms.default' in code, len(program.state_dict) > 0, leaked)
'''


def test_cli_pt2_runs_without_jax(targets, tmp_path):
    """``export m.pth m.pt2`` writes the largest profile's program with
    its weights inside; a process that cannot import JAX loads it, finds
    ``odtk::nms`` in its graph, and gets the ``.engine``'s outputs on the
    same batch within 1e-6."""
    _, _, engine, ckpt = targets
    pt2 = str(tmp_path / 'm.pt2')
    cli.main(['export', ckpt, pt2, '--size', '128', '--full-precision',
              '--dynamic-batch-opts', '1', '2', '2', '--threshold', '0.001',
              '--detections', '20', '--device', 'cpu'])
    x = images(2, seed=6)
    np.save(tmp_path / 'x.npy', x)
    code = _PT2_RUN.format(pt2=pt2, x=str(tmp_path / 'x.npy'),
                           out=str(tmp_path / 'out.npz'))
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    run = subprocess.run([sys.executable, '-c', code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split('\n')[-2] == 'True True []'
    got = np.load(tmp_path / 'out.npz')
    want = engine(x)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[f'arr_{i}'], w.numpy(), rtol=0,
                                   atol=1e-6)
    assert (want[0] > 0).sum() > 5
