"""Checkpoint save / load in the reference schema, ``.pth`` only.

Schema (``odtk_tpu/io/checkpoint.py``): {backbone: [names], classes,
state_dict, ratios, scales, [angles], iteration, optimizer, scheduler}.
``state_dict`` holds fp32 CPU tensors under torch names with OIHW
kernels, so the model half of a file round-trips with the JAX package in
both directions. ``scheduler`` is ``{'last_iter': iteration}`` in both.
A rotated-box model writes its ``angles``, and a file with ``angles``
loads as a rotated-box model. ``optimizer`` is framework-specific: this
package writes a ``torch.optim`` state_dict, the JAX package msgpack
``bytes`` of its optax state. Neither reads the other's: the port's
trainer starts the momentum fresh from a JAX-written file (with a
warning), and the JAX trainer cannot resume from a port-written one.
Files are read with
``torch.load(weights_only=True)``, which accepts both.
"""

import os

import torch

_TORCH_EXTS = ('.pth', '.torch')


def _check_ext(path):
    if os.path.splitext(path)[1] not in _TORCH_EXTS:
        raise ValueError(f'{path}: only .pth / .torch checkpoints are '
                         'supported by odtk_tpu_torch')


def _to_cpu(obj):
    """Tensors anywhere in nested dicts / lists moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save(model, state):
    """Write the checkpoint to ``state['path']``."""
    path = state['path']
    _check_ext(path)
    checkpoint = {
        'backbone': list(model.backbones),
        'classes': int(model.classes),
        'ratios': [float(r) for r in model.ratios],
        'scales': [float(s) for s in model.scales],
    }
    if model.rotated_bbox and model.angles:
        checkpoint['angles'] = [float(a) for a in model.angles]
    checkpoint['state_dict'] = {
        k: v.detach().to('cpu', torch.float32).contiguous()
        for k, v in model.module.state_dict().items()}
    for key in ('iteration', 'optimizer', 'scheduler'):
        if key in state:
            checkpoint[key] = _to_cpu(state[key])
    tmp = path + '.tmp'
    torch.save(checkpoint, tmp)
    os.replace(tmp, path)


def read(filename):
    """The checkpoint dict of ``filename``, tensors on the CPU."""
    if not os.path.isfile(filename):
        raise ValueError('No checkpoint {}'.format(filename))
    _check_ext(filename)
    return torch.load(filename, map_location='cpu', weights_only=True)


def load(filename, device='cpu', rotated_bbox=False):
    """Rebuild a Model from a checkpoint: returns (model, state), the
    state holding iteration / optimizer / scheduler where present. A
    file with ``angles`` (or ``rotated_bbox=True``) gives a rotated-box
    model."""
    from ..model import Model

    checkpoint = read(filename)
    kwargs = {k: checkpoint[k] for k in ('ratios', 'scales', 'angles')
              if k in checkpoint}
    if 'angles' in checkpoint or rotated_bbox:
        kwargs['rotated_bbox'] = True
    model = Model(backbones=checkpoint['backbone'],
                  classes=int(checkpoint['classes']), **kwargs)
    model.module.load_state_dict(checkpoint['state_dict'], strict=True)
    model.to(device)
    state = {k: checkpoint[k] for k in ('iteration', 'optimizer', 'scheduler')
             if k in checkpoint}
    return model, state
