"""One backbone's weights from a torchvision-format state_dict file.

Counterpart of ``odtk_tpu/io/torch_import.py:load_backbone_weights``
(the model-zoo init of the original's ``backbones/resnet.py:20-22``)
from a file: ``--backbone-weights`` names one, and the default ImageNet
init (``io/model_zoo.py``) finds one in the cache directories, or
downloads it. It takes what the JAX function takes and refuses what it
refuses, with its message, which names the refused tensors by their JAX
variables path.
"""

import torch

from .jax_bridge import flax_key


def load_backbone_weights(model, backbone_name, path):
    """Fill backbone ``backbone_name`` of ``model`` (a ``Model`` on any
    device) from ``path``, a torchvision-format state_dict (read with
    ``torch.load(weights_only=True)``; a ``state_dict`` entry is
    unwrapped). Its keys ('conv1.weight', 'layer1.0.conv1.weight',
    'features.3.conv.0.0.weight') are prefixed with
    ``backbones.<Name>.features.``; the classifier heads ``fc.*`` and
    ``classifier.*`` are dropped; every other tensor of the model keeps
    its value. Raises ValueError, naming up to three, when tensors of the
    file match no tensor of the model or match one of another shape.
    Returns the names filled."""
    raw = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(raw, dict) and 'state_dict' in raw:
        raw = raw['state_dict']
    prefix = f'backbones.{backbone_name}.features.'
    # grouped by module in the order the JAX fill reports them; a module
    # with running statistics is a batch norm
    modules = {}
    for k, v in raw.items():
        if k.startswith(('fc.', 'classifier.')) \
                or k.endswith('num_batches_tracked'):
            continue
        module, leaf = (prefix + k).rsplit('.', 1)
        modules.setdefault(module, {})[leaf] = v
    own = model.module.state_dict()
    filled, unmatched = {}, []
    for module, leaves in modules.items():
        for leaf, value in leaves.items():
            name = f'{module}.{leaf}'
            if name in own and own[name].shape == value.shape:
                filled[name] = value
            else:
                unmatched.append(flax_key(name, value.ndim,
                                          'running_mean' in leaves))
    if unmatched:
        raise ValueError(
            f'{len(unmatched)} tensors in {path} did not match the '
            f'{backbone_name} backbone, e.g. {unmatched[:3]}')
    with torch.no_grad():
        for name, value in filled.items():
            own[name].copy_(value)
    return sorted(filled)
