"""The momentum of ``torch.optim.SGD`` as the JAX package's optax state,
and back.

The JAX trainer's optimizer (``odtk_tpu/train.py:make_optimizer``) is
the chain ``[clip_by_global_norm if clip_grads > 0]``,
``add_decayed_weights``, ``trace(momentum)``, ``scale_by_learning_rate``.
``flax.serialization.to_state_dict`` writes its state as
``{'0': {}, '1': {'trace': <params tree>}, '2': {'count': int32}}``, each
index one higher with the clip. optax's ``trace`` and torch's
``momentum_buffer`` (dampening 0) both compute
``buf = momentum * buf + (g + weight_decay * p)``, so the buffer carries
over exactly: a conv kernel's trace is its buffer in HWIO. Parameters
are matched by name (``named_parameters`` through
``jax_bridge.flax_key``), never by position; the frozen batch norm has
no momentum.

``count``: the JAX schedule reads ``count``, the number of updates that
were applied, because a step with a non-finite gradient leaves the whole
optax state untouched (``odtk_tpu/train.py:149-159``). The port's
schedule reads the iteration, and its trainer counts the applied
updates beside it: the two are equal until a step is skipped, and each
skipped step puts ``count`` one behind the iteration. A file written
here carries the count the JAX trainer would have had; a file read here
gives the port its count back (a ``.pth`` with a torch state_dict holds
none, and the trainer then takes the iteration).
"""

import warnings

import numpy as np
import torch

from .jax_bridge import flax_key, from_jax_layout, to_jax_layout
from .msgpack import msgpack_restore


def chain_layout(clip_grads):
    """(entries, index of the trace, index of the count) of the chain the
    JAX trainer builds for ``clip_grads``."""
    clip = 1 if clip_grads and clip_grads > 0 else 0
    return 3 + clip, 1 + clip, 2 + clip


def _param_paths(module):
    """(name, parameter, its path inside the JAX params tree)."""
    return [(name, p, flax_key(name, p.ndim)[1:])
            for name, p in module.named_parameters()]


def to_optax(optimizer, module, clip_grads, count):
    """The optax state of ``optimizer`` (SGD over ``module``'s
    parameters) in ``to_state_dict`` layout: nested dicts of numpy
    arrays, the trace fp32, ``count`` an int32 0-d array."""
    entries, trace_at, count_at = chain_layout(clip_grads)
    trace = {}
    for _, p, path in _param_paths(module):
        buf = optimizer.state.get(p, {}).get('momentum_buffer')
        if buf is None:
            buf = torch.zeros_like(p)
        node = trace
        for token in path[:-1]:
            node = node.setdefault(token, {})
        node[path[-1]] = to_jax_layout(buf.float())
    tree = {str(i): {} for i in range(entries)}
    tree[str(trace_at)] = {'trace': trace}
    tree[str(count_at)] = {'count': np.asarray(count, np.int32)}
    return tree


class _Mismatch(Exception):
    pass


def _read(blob, module, clip_grads):
    """{parameter: momentum buffer (CPU, port layout)} and the count, or
    _Mismatch."""
    tree = msgpack_restore(blob)
    entries, trace_at, count_at = chain_layout(clip_grads)
    want = {str(i) for i in range(entries)}
    got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
    if got != sorted(want):
        raise _Mismatch(f'chain entries {got}, expected {sorted(want)} for '
                        f'clip_grads {clip_grads}')
    keys = {i: sorted(v) if isinstance(v, dict) else None
            for i, v in tree.items()}
    expect = {i: [] for i in want}
    expect.update({str(trace_at): ['trace'], str(count_at): ['count']})
    if keys != expect:
        raise _Mismatch(f'chain entries hold {keys}, expected {expect}')
    trace = tree[str(trace_at)]['trace']
    buffers = {}
    for name, p, path in _param_paths(module):
        node = trace
        for token in path:
            if not isinstance(node, dict) or token not in node:
                raise _Mismatch(f'no trace for {name}')
            node = node[token]
        if isinstance(node, dict) or np.ndim(node) != p.ndim:
            raise _Mismatch(f'the trace of {name} is not a {p.ndim}-D array')
        buf = from_jax_layout(node, p.ndim)
        if buf.shape != p.shape:
            raise _Mismatch(f'trace of {name} is {tuple(buf.shape)}, the '
                            f'parameter {tuple(p.shape)}')
        buffers[p] = buf
    return buffers, int(tree[str(count_at)]['count'])


def restore(optimizer, module, blob, clip_grads):
    """Set ``optimizer``'s momentum buffers from the msgpack bytes of an
    optax state and return its count. A state of another layout (another
    ``clip_grads``, other parameters) leaves the buffers as they are,
    with a warning, and returns None
    (``odtk_tpu/io/checkpoint.py:restore_opt_state``)."""
    try:
        buffers, count = _read(blob, module, clip_grads)
    except _Mismatch as e:
        warnings.warn('the checkpoint\'s optimizer state does not match '
                      f'this optimizer ({e}); starting the momentum fresh')
        return None
    for p, buf in buffers.items():
        optimizer.state[p]['momentum_buffer'] = buf.to(p.device, p.dtype)
    return count
