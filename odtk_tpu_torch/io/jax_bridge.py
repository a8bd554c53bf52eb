"""Weight bridge from the JAX package's variables to this package's
state_dict.

Counterpart of ``odtk_tpu/io/torch_import.py:variables_to_state_dict``,
which cannot be imported without JAX. Flax paths flatten torch's numeric
Sequential indices into the parent name (``layer1_0``); the same token
rule splits them back, conv kernels go HWIO -> OIHW, and the ``frozen``
batch-norm collection maps scale/bias/mean/var to weight/bias/
running_mean/running_var.
"""

import numpy as np
import torch

_FROZEN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
           'var': 'running_var'}


def _split_token(token):
    """'layer1_0' -> ['layer1', '0']; 'backbones_X' -> ['backbones', 'X'].
    The backbone name is one torch token even when it holds underscores
    and digits ('ResNeXt50_32x4dFPN')."""
    if token.startswith('backbones_'):
        return ['backbones', token[len('backbones_'):]]
    parts = token.split('_')
    out = [parts[0]]
    for p in parts[1:]:
        if p.isdigit():
            out.append(p)
        else:
            out[-1] = out[-1] + '_' + p
    return out


def module_name(path):
    """A flax module path ('backbones_ResNet18FPN/features/layer1_0/conv1',
    the JAX package's calibration-table key) -> the port's module name
    ('backbones.ResNet18FPN.features.layer1.0.conv1')."""
    return '.'.join(p for t in path.split('/') for p in _split_token(t))


def state_dict_from_jax(variables):
    """JAX ``{'params': ..., 'frozen': ...}`` pytree of array-likes ->
    {torch key: fp32 CPU tensor}, ready for ``load_state_dict``."""
    out = {}

    def walk(tree, tokens, coll):
        for k, v in tree.items():
            if hasattr(v, 'items'):
                walk(v, tokens + [k], coll)
                continue
            arr = np.asarray(v)
            toks = [p for t in tokens for p in _split_token(t)]
            if coll == 'frozen':
                leaf = _FROZEN[k]
            elif k == 'kernel' and arr.ndim == 4:
                leaf, arr = 'weight', arr.transpose(3, 2, 0, 1)
            else:
                leaf = k
            out['.'.join(toks + [leaf])] = torch.tensor(
                np.ascontiguousarray(arr))

    for coll, tree in variables.items():
        walk(tree, [], coll)
    return out
