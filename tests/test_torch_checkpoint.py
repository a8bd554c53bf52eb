"""``.ckpt`` checkpoints and optimizer state between odtk_tpu_torch and
the JAX package, on the CPU.

The codec (``odtk_tpu_torch/io/msgpack.py``) is held byte for byte to
``flax.serialization``; checkpoints written by either package load in
the other with their weights and momentum equal bit for bit (the
momentum only transposed: the optax trace is the torch buffer in the
JAX layout, so no arithmetic may touch it). The optax states come from
``tx.init`` with their trace drawn from a seeded numpy generator: no
train step is compiled.
"""

import os
import random
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from odtk_tpu import train as jax_train
from odtk_tpu.io import checkpoint as jax_checkpoint
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import main as cli
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch.io import checkpoint, msgpack, opt_state
from odtk_tpu_torch.io.jax_bridge import flax_key, state_dict_from_jax
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
ANGLES = [-0.5, 0.0, 0.5]
LR, WD = 0.01, 1e-4
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
        -2 ** 31 - 1, -2 ** 63]


def _codec_tree():
    """Every type the codec writes, at each of its encodings' sizes."""
    rng = np.random.default_rng(0)
    arrays = [
        np.zeros((), np.float32), np.zeros((0, 3), np.int64),
        rng.random(6) > 0.5,                      # 16-byte payload: fixext 16
        rng.integers(0, 255, (3, 4), dtype=np.uint8),
        rng.standard_normal((2, 3)).astype(np.float16),
        rng.integers(-9, 9, 5, dtype=np.int32),
        rng.standard_normal(300).astype(np.float32)[::2],   # not contiguous
        rng.standard_normal(7).astype(ml_dtypes.bfloat16),
        np.asarray(rng.standard_normal(()), ml_dtypes.bfloat16),
        rng.standard_normal((100, 200)).astype(np.float32),  # ext 32
    ]
    return {
        'ints': INTS, 'bools': [True, False, None],
        'floats': [0.5, -1e300, float('inf'), 0.0],
        'strs': ['', 'a' * 31, 'b' * 32, 'c' * 255, 'd' * 256, 'e' * 70000],
        'bins': [b'', b'x' * 255, b'y' * 256, b'z' * 70000],
        'arrays': {str(i): a for i, a in enumerate(arrays)},
        'scalars': {'f32': np.float32(1.5), 'i32': np.int32(-3),
                    'bool': np.bool_(True), 'i64': np.int64(2 ** 40),
                    'u8': np.uint8(7), 'f16': np.float16(2)},
        'order': {'10': 1, '2': 2, 'b': {}, 'a': []},
        'map16': {str(i): i for i in range(20)}, 'array16': list(range(20)),
        'nested': [{'z': np.arange(3, dtype=np.int32), 'a': [1.0]}],
    }


def _assert_same_tree(got, want, path=''):
    """``got`` (the port's decode) equals ``want`` (flax's) in values,
    types and dtypes; the port decodes bfloat16 to a torch tensor."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f'{path}/{i}')
    elif isinstance(got, torch.Tensor):
        assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want), path
        assert got == want or (got != got and want != want), path


def test_codec_bytes_equal_flax():
    """Byte-equal to ``flax.serialization.msgpack_serialize``, and flax's
    bytes decode to equal values and dtypes."""
    tree = _codec_tree()
    want = serialization.msgpack_serialize(tree)
    assert msgpack.msgpack_serialize(tree) == want
    _assert_same_tree(msgpack.msgpack_restore(want),
                      serialization.msgpack_restore(want))
    # torch tensors are written as the numpy arrays they hold
    t = {'w': torch.arange(12.0).reshape(3, 4),
         'b': torch.arange(5).to(torch.bfloat16)}
    assert msgpack.msgpack_serialize(t) == serialization.msgpack_serialize(
        {'w': t['w'].numpy(),
         'b': t['b'].float().numpy().astype(ml_dtypes.bfloat16)})
    with pytest.raises(TypeError):          # flax's strict packer too
        msgpack.msgpack_serialize({'t': (1, 2)})


def test_codec_chunked_leaves(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes reached through maps are split
    into flat chunks (also at the top level), arrays inside lists are
    not, as flax does: both modules' chunk size patched small."""
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(msgpack, 'MAX_CHUNK_SIZE', 64)
    rng = np.random.default_rng(1)
    tree = {'w': rng.standard_normal((10, 10)).astype(np.float32),
            'bf': rng.standard_normal(50).astype(ml_dtypes.bfloat16),
            'small': np.arange(4, dtype=np.int64),
            'in_list': [rng.standard_normal(40).astype(np.float32)],
            'deep': {'u8': rng.integers(0, 255, 200, dtype=np.uint8)}}
    want = serialization.msgpack_serialize(tree)
    assert b'__msgpack_chunked_array__' in want
    assert msgpack.msgpack_serialize(tree) == want
    _assert_same_tree(msgpack.msgpack_restore(want),
                      serialization.msgpack_restore(want))
    top = tree['w']
    assert msgpack.msgpack_serialize(top) == \
        serialization.msgpack_serialize(top)
    np.testing.assert_array_equal(
        msgpack.msgpack_restore(serialization.msgpack_serialize(top)), top)


def test_codec_arrays_are_views_of_the_buffer():
    """Arrays decode over the given buffer: writable from a bytearray,
    without a copy."""
    blob = bytearray(msgpack.msgpack_serialize(
        {'a': np.arange(64, dtype=np.float32)}))
    a = msgpack.msgpack_restore(blob)['a']
    assert a.flags.writeable and not a.flags.owndata
    a[0] = 7.0
    assert msgpack.msgpack_restore(blob)['a'][0] == 7.0


# ------------------------------------------------------------ checkpoints
def _jax_model(rotated=False, seed=0):
    model = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=rotated,
                     angles=ANGLES if rotated else None)
    model.initialize(rng=seed, image_size=(128, 128))
    return model


def _jax_opt_state(params, clip, count, seed=0):
    """tx.init's state with its trace drawn from a seeded generator."""
    tx = jax_train.make_optimizer(LR, 10, [50], 0.1, WD, clip_grads=clip)
    state = tx.init(params)
    _, trace_at, count_at = opt_state.chain_layout(clip)
    rng = np.random.default_rng(seed)
    trace = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        state[trace_at].trace)
    state = list(state)
    state[trace_at] = state[trace_at]._replace(trace=trace)
    state[count_at] = state[count_at]._replace(
        count=jnp.asarray(count, jnp.int32))
    return tx, tuple(state)


def _trace_by_name(trace, module):
    """{port parameter name: trace leaf as a torch tensor in the port's
    layout}."""
    out = {}
    for name, p in module.named_parameters():
        node = trace
        for token in flax_key(name, p.ndim)[1:]:
            node = node[token]
        arr = np.asarray(node)
        if p.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _assert_weights_equal(port_model, jax_model):
    want = variables_to_state_dict(jax_model.variables)
    got = port_model.module.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize('ext', ['.ckpt', '.pth'])
@pytest.mark.parametrize('clip', [0.0, 25.0])
def test_jax_checkpoint_loads_with_its_momentum(tmp_path, ext, clip):
    """A JAX-written file: the port's weights equal bit for bit, its SGD
    momentum buffers the transposed trace bit for bit, the optax count
    returned, and no warning."""
    jmodel = _jax_model()
    _, jopt = _jax_opt_state(jmodel.variables['params'], clip, count=6)
    path = str(tmp_path / f'jax{ext}')
    jmodel.save({'path': path, 'iteration': 7, 'optimizer': jopt,
                 'scheduler': {'last_iter': 7}})
    model, state = Model.load(path)
    _assert_weights_equal(model, jmodel)
    assert state['iteration'] == 7
    assert state['scheduler'] == {'last_iter': 7}
    optimizer = port_train.make_optimizer(model.module.parameters(), LR, WD)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        count = opt_state.restore(optimizer, model.module,
                                  state['optimizer'], clip)
    assert count == 6
    _, trace_at, _ = opt_state.chain_layout(clip)
    want = _trace_by_name(jax.device_get(jopt[trace_at].trace), model.module)
    for name, p in model.module.named_parameters():
        assert torch.equal(optimizer.state[p]['momentum_buffer'],
                           want[name]), name


@pytest.mark.parametrize('clip', [0.0, 25.0])
def test_port_checkpoint_resumes_in_jax(tmp_path, clip):
    """A port-written .ckpt: ``odtk_tpu.io.checkpoint.load`` gives the
    weights, ``restore_opt_state`` the trace (the port's momentum,
    transposed, bit for bit) and the count, with no warning; written the
    other way round, the layout of the other clip falls back to a fresh
    optimizer with a warning in both packages."""
    model = Model('ResNet18FPN', classes=CLASSES).initialize(3)
    optimizer = port_train.make_optimizer(model.module.parameters(), LR, WD)
    gen = torch.Generator().manual_seed(4)
    for p in model.module.parameters():
        optimizer.state[p]['momentum_buffer'] = torch.randn(
            p.shape, generator=gen)
    path = str(tmp_path / 'port.ckpt')
    model.save({'path': path, 'iteration': 9,
                'optimizer': opt_state.to_optax(optimizer, model.module,
                                                clip, count=8),
                'scheduler': {'last_iter': 9}})
    jmodel, jstate = jax_checkpoint.load(path)
    _assert_weights_equal(model, jmodel)
    assert jstate['iteration'] == 9
    tx = jax_train.make_optimizer(LR, 10, [50], 0.1, WD, clip_grads=clip)
    template = tx.init(jmodel.variables['params'])
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        restored = jax_checkpoint.restore_opt_state(jstate['optimizer'],
                                                    template)
    _, trace_at, count_at = opt_state.chain_layout(clip)
    assert int(restored[count_at].count) == 8
    want = _trace_by_name(restored[trace_at].trace, model.module)
    for name, p in model.module.named_parameters():
        assert torch.equal(optimizer.state[p]['momentum_buffer'],
                           want[name]), name

    other = 0.0 if clip else 25.0
    wrong = jax_train.make_optimizer(LR, 10, [50], 0.1, WD,
                                     clip_grads=other)
    with pytest.warns(UserWarning, match='starting it fresh'):
        jax_checkpoint.restore_opt_state(
            jstate['optimizer'], wrong.init(jmodel.variables['params']))
    fresh = port_train.make_optimizer(model.module.parameters(), LR, WD)
    with pytest.warns(UserWarning, match='starting the momentum fresh'):
        assert opt_state.restore(fresh, model.module,
                                 jstate['optimizer'], other) is None
    assert all(not fresh.state[p]['momentum_buffer'].any()
               for p in model.module.parameters())


def test_ckpt_bytes_equal_the_jax_packages(tmp_path):
    """The same weights and state written by both packages as .ckpt give
    the same bytes."""
    jmodel = _jax_model(seed=5)
    _, jopt = _jax_opt_state(jmodel.variables['params'], 0.0, count=3)
    jpath, ppath = str(tmp_path / 'jax.ckpt'), str(tmp_path / 'port.ckpt')
    jmodel.save({'path': jpath, 'iteration': 3, 'optimizer': jopt,
                 'scheduler': {'last_iter': 3}})
    model, state = Model.load(jpath)
    optimizer = port_train.make_optimizer(model.module.parameters(), LR, WD)
    count = opt_state.restore(optimizer, model.module, state['optimizer'],
                              0.0)
    model.save({'path': ppath, 'iteration': 3,
                'optimizer': opt_state.to_optax(optimizer, model.module, 0.0,
                                                count),
                'scheduler': {'last_iter': 3}})
    with open(jpath, 'rb') as f, open(ppath, 'rb') as g:
        assert f.read() == g.read()
    assert not os.path.exists(ppath + '.tmp')


def test_rotated_ckpt_round_trips_both_ways(tmp_path):
    """A rotated model's .ckpt (with ``angles``) loads as a rotated model
    of the same angles and weights in the other package, each way."""
    jmodel = _jax_model(rotated=True, seed=1)
    jpath = str(tmp_path / 'jax_rot.ckpt')
    jmodel.save({'path': jpath, 'iteration': 2})
    model, state = Model.load(jpath)
    assert model.rotated_bbox and model.angles == ANGLES
    assert state['iteration'] == 2
    _assert_weights_equal(model, jmodel)

    port = Model('ResNet18FPN', classes=CLASSES, rotated_bbox=True,
                 angles=ANGLES).initialize(2)
    ppath = str(tmp_path / 'port_rot.ckpt')
    port.save({'path': ppath, 'iteration': 5})
    back, jstate = jax_checkpoint.load(ppath)
    assert back.rotated_bbox and list(back.angles) == ANGLES
    assert jstate['iteration'] == 5
    _assert_weights_equal(port, back)


def test_peek_iteration_and_fine_tune_donor(tmp_path):
    """``peek_iteration`` agrees with the JAX package's on both formats
    and either package's files; a .ckpt is a fine-tune donor as a .pth
    is; a file in neither format raises."""
    jmodel = _jax_model()
    port = Model('ResNet18FPN', classes=CLASSES).initialize(1)
    for i, ext in enumerate(['.ckpt', '.pth']):
        jpath = str(tmp_path / f'jax{ext}')
        ppath = str(tmp_path / f'port{ext}')
        jmodel.save({'path': jpath, 'iteration': 11 + i})
        port.save({'path': ppath, 'iteration': 21 + i})
        for path, want in ((jpath, 11 + i), (ppath, 21 + i)):
            assert checkpoint.peek_iteration(path) == want
            assert jax_checkpoint.peek_iteration(path) == want
    tuned = Model('ResNet18FPN', classes=CLASSES).initialize(
        2, fine_tune=str(tmp_path / 'port.ckpt'))
    for k, v in tuned.module.state_dict().items():
        if not k.startswith('cls_head.8.'):
            assert torch.equal(v, port.module.state_dict()[k]), k
    bad = tmp_path / 'bad.ckpt'
    bad.write_bytes(b'\xc1 not msgpack')
    with pytest.raises(ValueError, match='not a torch'):
        checkpoint.read(str(bad))


def test_cli_train_resume_infer_ckpt(tmp_path):
    """``train x.ckpt`` for 2 iterations, a resume to 3 (the momentum
    restored: no warning), then ``infer x.ckpt`` on the CPU."""
    img, ann = make_dataset(str(tmp_path), n_images=4, size=(96, 128),
                            fmt='jpg')
    ckpt = str(tmp_path / 'model.ckpt')
    common = ['--images', img, '--annotations', ann, '--batch', '2',
              '--resize', '96', '--max-size', '128', '--device', 'cpu']
    train = ['train', ckpt, '--backbone', 'ResNet18FPN', '--classes', '3',
             '--jitter', '96', '112', '--warmup', '1', '--milestones', '1',
             '--full-precision', '--no-pretrained'] + common
    random.seed(0)
    first = cli.main(train + ['--iters', '2'])
    assert [it for it, _, _ in first['losses']] == [0, 1]
    assert checkpoint.peek_iteration(ckpt) == 2
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)
        second = cli.main(train + ['--iters', '3'])
    assert [it for it, _, _ in second['losses']] == [2]
    assert np.isfinite(np.asarray(first['losses'] + second['losses'])).all()
    model, state = Model.load(ckpt)
    assert state['iteration'] == 3
    jmodel, jstate = jax_checkpoint.load(ckpt)
    _assert_weights_equal(model, jmodel)
    tx = jax_train.make_optimizer(0.01, 1, [1], 0.1, 1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        restored = jax_checkpoint.restore_opt_state(
            jstate['optimizer'], tx.init(jmodel.variables['params']))
    assert int(restored[2].count) == 3
    result = cli.main(['infer', ckpt, '--output', str(tmp_path / 'det.json'),
                       '--threshold', '0.001'] + common)
    assert result['stats'] is not None and len(result['stats']) == 12


def test_jax_pth_momentum_resumes_in_port_trainer(tmp_path):
    """The port's trainer resumes a JAX-written .pth with its optax
    momentum (no warning) and writes the torch state_dict back."""
    img, ann = make_dataset(str(tmp_path), n_images=2, size=(96, 128),
                            fmt='jpg')
    jmodel = _jax_model()
    _, jopt = _jax_opt_state(jmodel.variables['params'], 0.0, count=4)
    path = str(tmp_path / 'jax.pth')
    jmodel.save({'path': path, 'iteration': 4, 'optimizer': jopt})
    model, state = Model.load(path)
    state['path'] = path
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)
        out = port_train.train(
            model, state, img, ann, img, None, 96, 128, [96, 96], 2, 5, 0,
            0.01, 0, [], 0.1, mixed_precision=False, verbose=False,
            device='cpu')
    assert [it for it, _, _ in out['losses']] == [4]
    _, resumed = Model.load(path)
    assert resumed['iteration'] == 5
    assert set(resumed['optimizer']) == {'state', 'param_groups'}
    # the file's weights came over too
    assert state_dict_from_jax(jmodel.variables).keys() == \
        model.module.state_dict().keys()
