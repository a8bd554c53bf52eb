"""Weight bridge between the JAX package's variables and this package's
state_dict, both ways.

Counterpart of ``odtk_tpu/io/torch_import.py:variables_to_state_dict``
and ``_merge_tokens``, which cannot be imported without JAX. Flax paths
flatten torch's numeric Sequential indices into the parent name
(``layer1_0``); the same token rule splits them back, conv kernels go
HWIO <-> OIHW, and the ``frozen`` batch-norm collection maps
scale/bias/mean/var to weight/bias/running_mean/running_var.
"""

import numpy as np
import torch

_FROZEN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
           'var': 'running_var'}
_TO_FROZEN = {v: k for k, v in _FROZEN.items()}


def _merge_tokens(tokens):
    """['layer1', '0', 'conv1'] -> ['layer1_0', 'conv1']; the token after
    'backbones' merges whole, underscores and all
    ('backbones_ResNeXt50_32x4dFPN')."""
    out = []
    for t in tokens:
        if out and (t.isdigit() or (len(out) == 1 and out[0] == 'backbones')):
            out[-1] = out[-1] + '_' + t
        else:
            out.append(t)
    return out


def flax_key(name, ndim, batch_norm=False):
    """A port state_dict key -> its JAX variables path: the collection
    ('params', or 'frozen' for a batch-norm statistic), the flax module
    path, the leaf ('kernel' for a 2-D or 4-D weight)."""
    path, leaf = name.rsplit('.', 1)
    tokens = tuple(_merge_tokens(path.split('.')))
    if batch_norm:
        return ('frozen',) + tokens + (_TO_FROZEN[leaf],)
    if leaf == 'weight' and ndim in (2, 4):
        leaf = 'kernel'
    return ('params',) + tokens + (leaf,)


def to_jax_layout(tensor):
    """A port tensor as the JAX package stores it, a numpy array: conv
    weights OIHW -> HWIO, linear weights transposed."""
    arr = tensor.detach()
    if arr.ndim == 4:
        arr = arr.permute(2, 3, 1, 0)
    elif arr.ndim == 2:
        arr = arr.t()
    return arr.contiguous().cpu().numpy()


def from_jax_layout(arr, ndim):
    """``to_jax_layout`` inverted: a JAX leaf of a ``ndim``-D port
    tensor, as a CPU tensor in the port's layout (a copy)."""
    arr = np.asarray(arr)
    if ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif ndim == 2:
        arr = arr.T
    return torch.from_numpy(np.array(arr, order='C'))


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
