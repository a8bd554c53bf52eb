"""Checkpoint save / load in the reference schema, ``.pth`` and ``.ckpt``.

Schema (``odtk_tpu/io/checkpoint.py``): {backbone: [names], classes,
state_dict, ratios, scales, [angles], iteration, optimizer, scheduler}.
``state_dict`` holds fp32 tensors under torch names with OIHW kernels,
so the model half of a file round-trips with the JAX package in both
directions. ``scheduler`` is ``{'last_iter': iteration}`` in both. A
rotated-box model writes its ``angles``, and a file with ``angles``
loads as a rotated-box model.

Two formats, by extension, as the JAX package has them:

- ``.pth`` / ``.torch``: ``torch.save``, read with
  ``torch.load(weights_only=True)``. ``optimizer`` is a ``torch.optim``
  state_dict, as in the original ODTK's schema; in a file the JAX
  package wrote, the msgpack ``bytes`` of its optax state.
- anything else (``.ckpt``): flax msgpack (``io/msgpack.py``), written
  to ``<path>.tmp`` and renamed into place. ``optimizer`` is the msgpack
  bytes of the optax state (``io/opt_state.py``), in either package.

The trainer (``train.py``) restores the momentum from either kind of
``optimizer``, and writes the kind of its path's extension. The JAX
trainer reads the optax bytes of either format; on a port-written
``.pth``'s torch state_dict it raises ``TypeError``
(``odtk_tpu/io/checkpoint.py:restore_opt_state`` takes ``bytes()`` of
it), unless it is run with ``--override``, which starts a fresh model
and does not read the file.
"""

import mmap
import os
import struct

import torch

from .msgpack import msgpack_restore, msgpack_serialize, serialize_parts

_TORCH_EXTS = ('.pth', '.torch')


def is_torch_format(path):
    return os.path.splitext(path)[1] in _TORCH_EXTS


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
    """Write the checkpoint to ``state['path']``. For a ``.ckpt``,
    ``state['optimizer']`` is the optax state's tree
    (``opt_state.to_optax``) or its msgpack bytes."""
    path = state['path']
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
    if is_torch_format(path):
        torch.save(checkpoint, tmp)
    else:
        if isinstance(checkpoint.get('optimizer'), dict):
            checkpoint['optimizer'] = msgpack_serialize(
                checkpoint['optimizer'])
        with open(tmp, 'wb') as f:
            for part in serialize_parts(checkpoint):
                f.write(part)
    os.replace(tmp, path)


def _restore(buf, filename):
    try:
        checkpoint = msgpack_restore(buf, bin_views=True)
    except (ValueError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f'{filename}: not a torch (.pth, .torch) or '
                         f'msgpack (.ckpt) checkpoint ({e})') from None
    if not isinstance(checkpoint, dict) or 'state_dict' not in checkpoint:
        raise ValueError(f'{filename}: a msgpack file without a state_dict')
    return checkpoint


def read(filename):
    """The checkpoint dict of ``filename``, tensors on the CPU. From a
    ``.ckpt`` the tensors are views of the file's bytes, read once, and
    ``optimizer`` is a memoryview of them."""
    if not os.path.isfile(filename):
        raise ValueError('No checkpoint {}'.format(filename))
    if is_torch_format(filename):
        return torch.load(filename, map_location='cpu', weights_only=True)
    with open(filename, 'rb') as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    checkpoint = _restore(buf, filename)
    checkpoint['state_dict'] = {k: torch.from_numpy(v) for k, v in
                                checkpoint['state_dict'].items()}
    return checkpoint


def peek_iteration(filename):
    """The recorded training iteration of a checkpoint (0 if absent),
    without building the model (a ``.ckpt`` is mapped, not read)."""
    if is_torch_format(filename):
        checkpoint = torch.load(filename, map_location='cpu',
                                weights_only=True)
        return int(checkpoint.get('iteration', 0))
    with open(filename, 'rb') as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        view = memoryview(mm)
        try:
            return int(_restore(view, filename).get('iteration', 0))
        except ValueError as e:
            # raised below, once the traceback that holds the decoder's
            # views of the map is gone: release() refuses while they live
            error = str(e)
        finally:
            view.release()
    raise ValueError(error)


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
