"""odtk_tpu_torch's other backbones held against the JAX package on the
CPU: MobileNetV2FPN, the single-level ResNet18C4 / ResNet34C4, and a
model of two backbones (ResNet18FPN + MobileNetV2FPN, 10 levels). Their
engines, fine-tuning and the loss and matcher past eight levels are in
``tests/test_torch_backbone_paths.py``.

Each model's JAX variables are drawn once per module, with the frozen
batch-norm statistics redrawn by numpy (so no batch norm is the
identity); the port gets them through the weight bridge or a ``.pth``
the JAX package writes. Inputs are made by numpy from seeds, and
everything runs in fp32. Each test states its tolerance.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from odtk_tpu import backbones as jax_backbones
from odtk_tpu import quantize as jax_quantize
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import backbones
from odtk_tpu_torch import quantize
from odtk_tpu_torch.backbones.layers import QuantConv2d
from odtk_tpu_torch.io.jax_bridge import module_name, state_dict_from_jax
from odtk_tpu_torch.model import Model
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
SIZE = 128
MODELS = {'mobilenet': ('MobileNetV2FPN',), 'c4': ('ResNet18C4',),
          'pair': ('ResNet18FPN', 'MobileNetV2FPN')}
LEVELS = {'mobilenet': 5, 'c4': 1, 'pair': 10}


def _draw_frozen(variables, seed):
    """The variables with every frozen batch-norm tensor redrawn: var and
    scale in [0.5, 1.5), mean and bias N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key in ('var', 'scale'):
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return dict(variables, frozen=jax.tree_util.tree_map_with_path(
        draw, variables['frozen']))


@pytest.fixture(scope='module')
def jax_variables():
    """{model key: JAX variables} of the three models, 3 classes."""
    out = {}
    for i, (key, names) in enumerate(MODELS.items()):
        model = JaxModel(list(names), classes=CLASSES)
        v = jax.tree.map(np.asarray, model.initialize(
            rng=i, image_size=(SIZE, SIZE)))
        out[key] = _draw_frozen(v, 10 + i)
    return out


def _port(key, variables, config=None):
    model = Model(list(MODELS[key]), classes=CLASSES, config=config)
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _images(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, SIZE, SIZE, 3) * 0.5).astype(np.float32)


def _targets(seed=0, b=2, m=6):
    """[b, m, 5] (x, y, w, h, class) rows, -1-padded: boxes of 16-100 px,
    the sizes of the stride 8-32 anchors."""
    rng = np.random.RandomState(seed)
    t = np.full((b, m, 5), -1.0, np.float32)
    for i, k in enumerate((m, m // 2)):
        wh = rng.uniform(16, 100, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * (SIZE - wh)
        t[i, :k, :2], t[i, :k, 2:4] = xy, wh
        t[i, :k, 4] = rng.randint(0, CLASSES, k)
    return t


def test_registry_matches_jax():
    assert backbones.available() == jax_backbones.available()
    assert len(backbones.available()) == 10


def test_c4_builds_no_stage_past_layer3():
    """A C4 net holds layer1-layer3 only (a JAX C4 checkpoint has no
    layer4 keys) and returns one level: layer3's output, stride 16, 256
    channels; an FPN ResNet keeps its three taps."""
    c4 = backbones.build('ResNet34C4')
    keys = list(c4.state_dict())
    assert keys[0] == 'features.conv1.weight'
    assert 'features.layer3.5.bn2.running_var' in keys
    assert not any('layer4' in k for k in keys)
    assert c4.features.feature_channels == [256]
    with torch.no_grad():
        out = c4(torch.zeros(1, 3, SIZE, SIZE))
    assert [tuple(o.shape) for o in out] == [(1, 256, 8, 8)]
    fpn = backbones.build('ResNet50FPN')
    assert fpn.features.feature_channels == [512, 1024, 2048]


@pytest.mark.parametrize('key', list(MODELS))
def test_jax_checkpoints_load_strictly(jax_variables, key, tmp_path):
    """A ``.pth`` the JAX package writes, and ``state_dict_from_jax``,
    both load with ``strict=True`` and give the JAX package's own torch
    export of the variables, tensor for tensor."""
    variables = jax_variables[key]
    want = variables_to_state_dict(variables)
    bridged = state_dict_from_jax(variables)
    assert sorted(bridged) == sorted(want)
    jmodel = JaxModel(list(MODELS[key]), classes=CLASSES)
    jmodel.variables = variables
    path = str(tmp_path / 'jax.pth')
    jmodel.save({'path': path, 'iteration': 4})
    port, state = Model.load(path)
    assert port.backbones == list(MODELS[key]) and state['iteration'] == 4
    got = port.module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(bridged[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize('key', list(MODELS))
def test_heads_match_jax(jax_variables, key):
    """Per-level heads on 2 x 128 x 128 images, fp32: atol 1e-4 x
    max|head| (the convolutions sum in another order)."""
    variables = jax_variables[key]
    x = _images()
    jmodel = JaxModel(list(MODELS[key]), classes=CLASSES)
    want_cls, want_box = jax.jit(jmodel.module.apply)(variables, x)
    got_cls, got_box = _port(key, variables).forward_heads(
        torch.from_numpy(x))
    assert len(got_cls) == len(want_cls) == LEVELS[key]
    for got, want in zip(got_cls + got_box, want_cls + want_box):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('key', list(MODELS))
def test_loss_fn_and_gradients_match_jax(jax_variables, key):
    """Model.loss_fn (bridged weights, fp32) against the JAX
    Model.loss_fn: both losses at rtol 1e-4, and every parameter's
    gradient within 1e-3 of its largest entry (convolutions and the loss
    sum in other orders). C4 has one level, the pair 10 with its strides
    repeated (anchor tables shared by stride)."""
    variables = jax_variables[key]
    images, targets = _images(seed=1), _targets(seed=2)
    jmodel = JaxModel(list(MODELS[key]), classes=CLASSES)

    def f(p):
        cl, bl = jmodel.loss_fn({'params': p, 'frozen': variables['frozen']},
                                images, targets)
        return cl + bl, (cl, bl)

    (_, (w_cl, w_bl)), w_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables['params'])

    model = _port(key, variables)
    cl, bl = model.loss_fn(torch.from_numpy(images), torch.from_numpy(targets))
    (cl + bl).backward()
    assert bl.item() > 0                    # foreground anchors were met
    np.testing.assert_allclose(cl.item(), float(w_cl), rtol=1e-4)
    np.testing.assert_allclose(bl.item(), float(w_bl), rtol=1e-4)
    got = {k: p.grad for k, p in model.module.named_parameters()}
    want = state_dict_from_jax({'params': w_g})
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    strides = sorted(model._anchors)
    assert strides == ([16] if key == 'c4' else [8, 16, 32, 64, 128])


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


def test_c4_inference_fn_matches_jax(jax_variables):
    """ResNet18C4's whole inference (backbone, heads, the one level
    through ``decode_fused``, NMS) on the same weights, the final head
    kernels redrawn at std 1.0 / 0.2 so the logits spread; fp32,
    threshold 0.001. Detections matched by (class, score): scores atol
    1e-5, boxes atol 1e-2 px."""
    variables = jax_variables['c4']
    rng = np.random.RandomState(3)
    params = dict(variables['params'])
    for name, std in (('cls_head_8', 1.0), ('box_head_8', 0.2)):
        kernel = params[name]['kernel']
        params[name] = dict(params[name], kernel=(
            rng.randn(*kernel.shape) * std).astype(np.float32))
    variables = dict(variables, params=params)
    config = {'threshold': 0.001}
    x = _images(seed=4)
    jmodel = JaxModel(['ResNet18C4'], classes=CLASSES, config=config)
    want = jax.jit(jmodel.inference_fn)(variables, x)
    got = _port('c4', variables, config).inference_fn(torch.from_numpy(x))
    for i in range(2):
        g = _by_class_score(*(t[i].numpy() for t in got))
        w = _by_class_score(*(np.asarray(t[i]) for t in want))
        assert len(g[0]) == len(w[0]) > 10
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-2)


def test_mobilenet_w8a16_depthwise_matches_jax(jax_variables):
    """``build_quant_variables`` on MobileNetV2FPN with every convolution
    calibrated: the same layers quantized, the int8 weights equal after
    HWIO -> OIHW, the per-output-channel scales equal, the same size
    statistics; each depthwise convolution keeps its groups, and its
    forward is the convolution by the dequantized weights."""
    variables = jax_variables['mobilenet']
    keys = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif k == 'kernel' and np.ndim(v) == 4:
                keys.append('/'.join(path))

    walk(variables['params'], [])
    table = {k: 1.0 for k in keys}
    qvars, jstats = jax_quantize.build_quant_variables(variables, table)
    module, stats = quantize.build_quant_variables(
        copy.deepcopy(_port('mobilenet', variables).module),
        {module_name(k): v for k, v in table.items()})
    assert stats == jstats
    convs = {n: m for n, m in module.named_modules()
             if isinstance(m, QuantConv2d)}
    assert len(convs) == len(keys) == stats['quantized_tensors']
    depthwise = 0
    for key in keys:
        node, qnode = qvars['params'], qvars['quant']
        for part in key.split('/'):
            node, qnode = node[part], qnode[part]
        conv = convs[module_name(key)]
        np.testing.assert_array_equal(
            conv.weight.numpy(), np.asarray(node['kernel']).transpose(
                3, 2, 0, 1), err_msg=key)
        np.testing.assert_array_equal(conv.w_scale.numpy(),
                                      np.asarray(qnode['w_scale']),
                                      err_msg=key)
        if conv.groups > 1:
            depthwise += 1
            assert conv.groups == conv.weight.shape[0]
            assert conv.weight.shape[1] == 1
            x = torch.randn(1, conv.groups, 9, 9,
                            generator=torch.Generator().manual_seed(0))
            w = conv.weight.float() * conv.w_scale[:, None, None, None]
            want = torch.nn.functional.conv2d(x, w, None, conv.stride,
                                              conv.padding, 1, conv.groups)
            torch.testing.assert_close(conv(x), want, rtol=0, atol=0)
    assert depthwise == 17
