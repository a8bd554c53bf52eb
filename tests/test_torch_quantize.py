"""odtk_tpu_torch's INT8 path held against the JAX package on the CPU:
calibration tables (absmax, percentile, and the entropy calibrator's
histograms and thresholds), the int8 weights of ``build_quant_variables``,
the w8a16 convolution's execution, the int8 engine, and the behaviour of
``tests/test_quantize.py`` (storage round trip, file size, table reuse).

Table keys differ only by naming: the JAX package keys a layer by its
flax path, the port by its module name (``io/jax_bridge.module_name``
maps one to the other). Both models carry the same weights (the weight
bridge) and run in fp32 on the same numpy inputs unless a test says
otherwise.
"""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu import quantize as jax_quantize
from odtk_tpu.export import Engine as JaxEngine
from odtk_tpu.export import calibrate as jax_calibrate
from odtk_tpu.export import export_model as jax_export_model
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import quantize
from odtk_tpu_torch.backbones.layers import QuantConv2d
from odtk_tpu_torch.export import Engine, calibrate, export_model
from odtk_tpu_torch.io.jax_bridge import module_name
from odtk_tpu_torch.model import Model

from synth import make_dataset
from test_torch_export import CONFIG, images, port_model, spread_variables
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope='module')
def variables():
    return spread_variables(seed=1)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('calib')
    img_dir, _ = make_dataset(str(root), n_images=2, size=(96, 96))
    return sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))


def _fresh_model():
    return Model('ResNet18FPN', classes=3).initialize(0)


def _jax_model(variables):
    model = JaxModel('ResNet18FPN', classes=3, config=CONFIG)
    model.variables = variables
    return model


def _mapped(table):
    return {module_name(k): v for k, v in table.items()}


@pytest.fixture(scope='module')
def jax_tables(variables, files, tmp_path_factory):
    """The JAX package's absmax and 99.5-percentile tables at 96x96."""
    root = tmp_path_factory.mktemp('tables')
    model = _jax_model(variables)
    return {p: jax_calibrate(model, (96, 96), files, percentile=p,
                             calibration_table=str(root / f'{p}.json'))
            for p in (None, 99.5)}


@pytest.mark.parametrize('percentile', [None, 99.5])
def test_calibration_table_matches_jax(variables, files, jax_tables,
                                       percentile, tmp_path):
    """Every convolution's input absmax (or 99.5th percentile of |input|,
    max-merged over the head's five levels and the images) within a
    relative 1e-5 of the JAX package's (the convolutions sum in another
    order); the same layers and method."""
    want = jax_tables[percentile]
    got = calibrate(port_model(variables), (96, 96), files,
                    percentile=percentile,
                    calibration_table=str(tmp_path / 't.json'))
    assert got['method'] == want['method'] and got['version'] == 2
    expect = _mapped(want['act_absmax'])
    assert sorted(got['act_absmax']) == sorted(expect)
    assert len(expect) > 20
    for k, v in expect.items():
        np.testing.assert_allclose(got['act_absmax'][k], v, rtol=1e-5,
                                   err_msg=k)


def test_percentile_over_16m_elements():
    """``torch.quantile`` refuses more than 16M elements; the port's
    percentile takes any size and equals ``jnp.percentile``'s linear
    interpolation (to one fp32 rounding)."""
    rng = np.random.RandomState(0)
    a = np.abs(rng.randn(17_000_001)).astype(np.float32)
    got = quantize.percentile(torch.from_numpy(a), 99.9).item()
    want = float(jnp.percentile(jnp.asarray(a), 99.9))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_histograms_and_entropy_thresholds_match_jax(variables, files,
                                                      jax_tables):
    """The entropy calibrator's second pass: the 2048-bin |input|
    histograms of every layer over the JAX absmax spans (the same total,
    and at most 0.1% of the elements in another bin: at a bin edge the two
    frameworks' fp32 activations, summed in other orders, fall on either
    side), and ``entropy_threshold`` equal on the same histograms."""
    absmax = jax_tables[None]['act_absmax']
    model = _jax_model(variables)
    x = np.asarray(images(1, size=96))
    want = jax_quantize.flatten_hist(jax_quantize.capture_activation_hist(
        model, jnp.asarray(x), absmax))
    got = quantize.capture_activation_hist(port_model(variables),
                                           torch.from_numpy(x),
                                           _mapped(absmax))
    assert sorted(got) == sorted(_mapped(want))
    for k, w in want.items():
        g = got[module_name(k)]
        assert g.sum() == w.sum(), k
        assert np.abs(g - w).sum() / 2 <= 1e-3 * w.sum(), k
    for k in sorted(want)[:6]:
        bw = absmax[k] / quantize.HIST_BINS
        assert quantize.entropy_threshold(want[k], bw) == \
            jax_quantize.entropy_threshold(want[k], bw)
    rng = np.random.RandomState(0)
    bulk = np.abs(rng.randn(200000)) * 0.5
    hist = np.histogram(np.concatenate([bulk, rng.uniform(9, 10, 50)]),
                        bins=2048, range=(0, 10))[0]
    t = quantize.entropy_threshold(hist, 10 / 2048)
    assert t == jax_quantize.entropy_threshold(hist, 10 / 2048)
    assert 1.0 < t < 6.0


def test_int8_weights_equal_jax(variables, jax_tables):
    """``build_quant_variables``: the same layers quantized, the int8
    weights equal after the HWIO -> OIHW layout change, the per-channel
    scales equal, the same size statistics."""
    table = jax_tables[None]['act_absmax']
    qvars, jstats = jax_quantize.build_quant_variables(variables, table)
    module, stats = quantize.build_quant_variables(
        copy.deepcopy(port_model(variables).module), _mapped(table))
    assert stats == jstats
    convs = {n: m for n, m in module.named_modules()
             if isinstance(m, QuantConv2d)}
    assert len(convs) == len(table) == stats['quantized_tensors']
    for key in table:
        node, qnode = qvars['params'], qvars['quant']
        for part in key.split('/'):
            node, qnode = node[part], qnode[part]
        conv = convs[module_name(key)]
        assert conv.weight.dtype == torch.int8
        np.testing.assert_array_equal(
            conv.weight.numpy(), np.asarray(node['kernel']).transpose(
                3, 2, 0, 1), err_msg=key)
        np.testing.assert_array_equal(conv.w_scale.numpy(),
                                      np.asarray(qnode['w_scale']))


def test_w8a16_heads_match_jax(variables, jax_tables):
    """The w8a16 convolutions executed in fp32 (int8 weights dequantized
    in the forward) against the JAX package's QuantConv on the same
    int8 variables: heads within 1e-4 of their scale."""
    table = jax_tables[None]['act_absmax']
    qvars, _ = jax_quantize.build_quant_variables(variables, table)
    model = port_model(variables)
    quantize.build_quant_variables(model.module, _mapped(table))
    x = images(1, size=96)
    want = _jax_model(variables).module.apply(qvars, jnp.asarray(x))
    got = model.forward_heads(torch.from_numpy(x))
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_int8_engine_matches_jax_int8_engine(variables, files, jax_tables,
                                             tmp_path):
    """The port's INT8 engine against the JAX package's on the same
    calibration table (each reads its copy, keyed its way): both compute
    in bf16 on the int8 weights, and bf16 rounds at other places in the
    two frameworks, so the top detections are compared at bf16's
    resolution: the same class for the best detection, scores within
    2e-2. The int8 package is under the fp32 one / 2.5."""
    jtable, ptable = str(tmp_path / 'jax.json'), str(tmp_path / 'port.json')
    want_table = dict(jax_tables[None])
    with open(jtable, 'w') as f:
        json.dump(want_table, f)
    with open(ptable, 'w') as f:
        json.dump(dict(want_table,
                       act_absmax=_mapped(want_table['act_absmax'])), f)
    jpath, ppath = str(tmp_path / 'jax.engine'), str(tmp_path / 'i8.engine')
    jmodel = _jax_model(variables)
    jax_export_model(jmodel, (128, 128), precision='int8', path=jpath,
                     dynamic_batch_opts=[1, 1, 1], calibration_files=files,
                     calibration_table=jtable)
    model = port_model(variables)
    export_model(model, (128, 128), precision='int8', path=ppath,
                 dynamic_batch_opts=[1, 1, 1], calibration_files=files,
                 calibration_table=ptable)
    fp32 = str(tmp_path / 'fp.engine')
    export_model(port_model(variables), (128, 128), precision='fp32',
                 path=fp32, dynamic_batch_opts=[1, 1, 1])
    assert os.path.getsize(ppath) < os.path.getsize(fp32) / 2.5
    eng = Engine.load(ppath)
    assert eng.scale_table['act_absmax'] == _mapped(
        want_table['act_absmax'])
    assert eng.variables['cls_head.0.weight'].dtype == torch.int8
    x = images(1, seed=7)
    got = [t[0].float().numpy() for t in eng(x)]
    want = [np.asarray(t[0]) for t in JaxEngine.load(jpath)(x)]
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    assert got[2][0] == want[2][0]
    np.testing.assert_allclose(got[0][:10], want[0][:10], rtol=0, atol=2e-2)


def test_calibration_table_reused(variables, files, tmp_path):
    """A second calibration reads the persisted table, not the images."""
    path = str(tmp_path / 'table.json')
    model = port_model(variables)
    t1 = calibrate(model, (96, 96), files, calibration_table=path)
    assert t1['version'] == 2 and len(t1['act_absmax']) > 20
    assert calibrate(model, (96, 96), [], calibration_table=path) == t1


def test_quantize_dequantize_close():
    """Per-channel int8 storage: each weight within one scale step / 2."""
    model = _fresh_model()
    sd = model.module.state_dict()
    q, meta = quantize.quantize_weights(sd)
    assert meta['quantized_tensors'] > 20
    deq = quantize.dequantize_weights(q, torch.float32)
    k, k2 = sd['cls_head.0.weight'], deq['cls_head.0.weight']
    absmax = k.abs().reshape(k.shape[0], -1).amax(1)[:, None, None, None]
    assert ((k - k2).abs() <= absmax / 127.0 / 2 + 1e-8).all()
    assert torch.equal(deq['cls_head.0.bias'], sd['cls_head.0.bias'])


def test_quantized_model_still_infers():
    """The fake-quant round trip: about 4x smaller, the logits perturbed
    slightly, the inference finite."""
    model = _fresh_model()
    x = torch.from_numpy(images(1))
    before = model.forward_heads(x)[0][0]
    stats = quantize.quantize_model(model)
    assert stats['ratio'] > 3.5
    after = model.forward_heads(x)[0][0]
    assert (after - before).abs().mean() < 0.2
    assert torch.isfinite(model.inference_fn(x)[0]).all()
