"""One-way torch-naming import: a hand-built reference-style state_dict
(keys written out as the reference toolkit / torchvision would emit
them) must land in the right flax slots with the right transposition."""

import numpy as np

from odtk_tpu.model import Model
from odtk_tpu.io.torch_import import state_dict_to_variables
from torch_threads import one_torch_thread  # noqa: F401


def test_reference_style_keys_import():
    m = Model(backbones='ResNet18FPN', classes=2)
    template = m.initialize(rng=0, image_size=(128, 128))

    # Build a state_dict from the template's shapes but with torch-style
    # key strings written out MANUALLY (not via variables_to_state_dict)
    rng = np.random.RandomState(0)

    def t(shape):  # torch OIHW conv tensor
        return rng.randn(*shape).astype(np.float32)

    sd = {}
    p = template['params']['backbones_ResNet18FPN']
    fz = template['frozen']['backbones_ResNet18FPN']

    def conv_key(name, flax_kernel):
        kh, kw, i, o = flax_kernel.shape
        sd[name] = t((o, i, kh, kw))

    conv_key('backbones.ResNet18FPN.features.conv1.weight',
             p['features']['conv1']['kernel'])
    for leaf, tname in [('scale', 'weight'), ('bias', 'bias'),
                        ('mean', 'running_mean'), ('var', 'running_var')]:
        sd[f'backbones.ResNet18FPN.features.bn1.{tname}'] = \
            rng.randn(*fz['features']['bn1'][leaf].shape).astype(np.float32)
    sd['backbones.ResNet18FPN.features.bn1.num_batches_tracked'] = \
        np.int64(42)   # must be dropped
    conv_key('backbones.ResNet18FPN.features.layer2.0.downsample.0.weight',
             p['features']['layer2_0']['downsample_0']['kernel'])
    conv_key('cls_head.8.weight', template['params']['cls_head_8']['kernel'])
    sd['cls_head.8.bias'] = rng.randn(
        *template['params']['cls_head_8']['bias'].shape).astype(np.float32)

    filled, report = state_dict_to_variables(sd, template)
    assert not report['unmatched'], report['unmatched']

    # conv kernel transposed OIHW -> HWIO
    got = np.asarray(filled['params']['backbones_ResNet18FPN']['features']
                     ['conv1']['kernel'])
    want = sd['backbones.ResNet18FPN.features.conv1.weight'].transpose(
        2, 3, 1, 0)
    np.testing.assert_array_equal(got, want)

    # bn landed in frozen with renamed leaves
    got = np.asarray(filled['frozen']['backbones_ResNet18FPN']['features']
                     ['bn1']['mean'])
    np.testing.assert_array_equal(
        got, sd['backbones.ResNet18FPN.features.bn1.running_mean'])

    # nested Sequential index (layer2.0.downsample.0) resolved
    got = np.asarray(filled['params']['backbones_ResNet18FPN']['features']
                     ['layer2_0']['downsample_0']['kernel'])
    want = sd['backbones.ResNet18FPN.features.layer2.0.downsample.0.weight'
              ].transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(got, want)

    # head final conv + bias
    got = np.asarray(filled['params']['cls_head_8']['bias'])
    np.testing.assert_array_equal(got, sd['cls_head.8.bias'])


def test_backbone_weights_from_torchvision_file(tmp_path):
    """Plain torchvision resnet18 naming (incl. fc.*) loads into the
    backbone; head params keep their init."""
    import torch
    from odtk_tpu.io.torch_import import load_backbone_weights

    m = Model(backbones='ResNet18FPN', classes=2)
    m.initialize(rng=0, image_size=(128, 128))

    rng = np.random.RandomState(1)
    sd = {}
    # walk our own template to enumerate required shapes, but write the
    # keys as torchvision would (strip our prefix)
    from odtk_tpu.io.torch_import import variables_to_state_dict
    full = variables_to_state_dict(m.variables)
    prefix = 'backbones.ResNet18FPN.features.'
    for k, v in full.items():
        if k.startswith(prefix):
            sd[k[len(prefix):]] = torch.from_numpy(
                rng.randn(*v.shape).astype(np.float32))
    sd['fc.weight'] = torch.zeros(1000, 512)   # classifier: must be dropped
    sd['fc.bias'] = torch.zeros(1000)
    path = str(tmp_path / 'resnet18.pth')
    torch.save(sd, path)

    before_head = np.asarray(m.variables['params']['cls_head_0']['kernel'])
    load_backbone_weights(m, 'ResNet18FPN', path)
    got = np.asarray(m.variables['params']['backbones_ResNet18FPN']
                     ['features']['conv1']['kernel'])
    want = sd['conv1.weight'].numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(got, want)
    # untouched head
    np.testing.assert_array_equal(
        np.asarray(m.variables['params']['cls_head_0']['kernel']),
        before_head)
