"""The C++ samples of ``odtk_tpu_torch/extras/cppapi`` built with CMake
against the CPU wheel's libtorch, and the rotated u8 ``.cppengine`` held
to the JAX package on the CPU.

With a CPU build of torch ``odtk_ops`` holds the ``odtk::`` schemas alone:
enough to load a package and print its contract, and a CPU package run
from C++ raises (the operators have no CPU implementation there). The
samples' GPU run is ``tests/test_torch_kernels.py``'s ``cuda`` test and
the smoke's ``cppapi`` phase.

One rotated fp32 ResNet18FPN ``.cppengine`` with the u8 contract at 128
px, batch 2, compiled once for the module, from the JAX model's numpy
weights through the weight bridge (``rotated_jax_variables``).
"""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.model import Model as JaxModel
from odtk_tpu.ops.color import IMAGENET_MEAN, IMAGENET_STD
from odtk_tpu_torch.export import export_cpp_engine, load_cpp_engine
from odtk_tpu_torch.extras.cppapi import build as cppapi_build
from test_torch_rotated import CLASSES
from test_torch_rotated_train import _port, rotated_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

CONFIG = {'threshold': 0.001, 'detections': 20}
OPS = ('nms', 'nms_rotated', 'bn_relu_pool')


@pytest.fixture(scope='module')
def jax_variables():
    return rotated_jax_variables()


@pytest.fixture(scope='module')
def package(jax_variables, tmp_path_factory):
    """(path, the package loaded back) of the rotated u8 .cppengine."""
    path = str(tmp_path_factory.mktemp('cppapi') / 'rotated.cppengine')
    export_cpp_engine(_port(jax_variables, CONFIG), (128, 128), batch=2,
                      path=path, precision='fp32', input_format='u8')
    return path, load_cpp_engine(path)


@pytest.fixture(scope='module')
def binaries():
    if shutil.which('cmake') is None:
        pytest.skip('cmake unavailable')
    return cppapi_build.build()


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


def test_rotated_u8_cppengine_matches_jax(jax_variables, package):
    """The package against the JAX package's ``.cppengine`` function
    (``odtk_tpu/export.py:export_cpp_engine``: ``(x / 255 - mean) / std``
    in the graph, then ``inference_fn``, boxes flattened) on the same u8
    batch and weights: detections matched by (class, score), scores within
    1e-5 and boxes within 1e-3 px (``test_engine_matches_jax_engine``'s
    tolerance), sin and cos within 1e-4 (``test_rotated_inference_fn_
    matches_jax``'s)."""
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=True,
                      config=CONFIG)

    @jax.jit
    def jax_cppengine(variables, images):
        x = (images.astype(jnp.float32) / 255.0 - IMAGENET_MEAN) \
            / IMAGENET_STD
        scores, boxes, classes = jmodel.inference_fn(variables, x)
        return scores, boxes.reshape(boxes.shape[0], -1), classes

    u8 = np.random.RandomState(15).randint(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)
    want = jax_cppengine(jax_variables, u8)
    got = package[1](torch.from_numpy(u8))
    assert got[1].shape == (2, 20 * 6) and got[1].dtype == torch.float32
    for i in range(2):
        g = _by_class_score(got[0][i].numpy(),
                            got[1][i].reshape(-1, 6).numpy(),
                            got[2][i].numpy())
        w = _by_class_score(np.asarray(want[0][i]),
                            np.asarray(want[1][i]).reshape(-1, 6),
                            np.asarray(want[2][i]))
        assert len(g[0]) == len(w[0]) > 5
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[1][:, :4], w[1][:, :4], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g[1][:, 4:], w[1][:, 4:], rtol=0,
                                   atol=1e-4)


def test_samples_build_against_libtorch(binaries):
    """CMake configures ``odtk_ops`` with the schemas alone (no kernel
    library with a CPU build of torch), ``odtk_export`` and
    ``odtk_infer``."""
    assert any('schemas only' in line for line in binaries['configure'])
    for name in ('odtk_export', 'odtk_infer'):
        assert os.access(binaries[name], os.X_OK), name


def test_odtk_export_prints_the_contract(binaries, package):
    """``odtk_export`` loads the package and prints its metadata, equal to
    what Python reads, and the u8 contract of the rotated engine."""
    path, loaded = package
    run = _run([binaries['odtk_export'], path])
    assert run.returncode == 0, run.stderr[-2000:]
    shown = {}
    for line in run.stdout.splitlines():
        if line.startswith('meta:'):
            key, _, value = line[len('meta:'):].strip().partition(' =')
            shown[key] = value.strip()
    assert shown == loaded.get_metadata()
    assert shown['input'] == 'u8' and shown['box_dim'] == '6'
    assert 'uint8 NHWC [2, 128, 128, 3]' in run.stdout
    assert 'boxes [2, 20 x 6]' in run.stdout


def test_cpp_schemas_equal_the_python_registration(binaries):
    """``odtk_export --schemas`` prints the three ``odtk::`` schemas that
    ``odtk_ops.cpp`` registers, equal to the Python registration's."""
    run = _run([binaries['odtk_export'], '--schemas'])
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.splitlines() == [
        str(getattr(torch.ops.odtk, op).default._schema) for op in OPS]


def test_odtk_export_rejects_what_is_not_a_package(binaries, tmp_path):
    junk = tmp_path / 'junk.cppengine'
    junk.write_bytes(b'ODTKCPP1' + b'\x00' * 64)
    run = _run([binaries['odtk_export'], str(junk)])
    assert run.returncode != 0
    assert str(junk) in run.stderr


def test_cpu_package_from_cpp_raises(binaries, package, tmp_path):
    """``odtk_infer`` on a CPU package exits non-zero at the first
    ``odtk::`` operator: the C++ registration has no CPU implementation,
    and nothing falls back to a plain version."""
    ppm = tmp_path / 'im.ppm'
    pixels = np.random.RandomState(0).randint(0, 256, (96, 128, 3))
    ppm.write_bytes(b'P6\n128 96\n255\n' + pixels.astype(np.uint8).tobytes())
    run = _run([binaries['odtk_infer'], package[0], str(ppm),
                str(tmp_path / 'out.ppm'), str(tmp_path / 'det.txt')])
    assert run.returncode != 0
    assert "Could not run 'odtk::" in run.stderr
    assert "from the 'CPU' backend" in run.stderr
    assert not (tmp_path / 'det.txt').exists()
