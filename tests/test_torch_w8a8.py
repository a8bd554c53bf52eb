"""odtk_tpu_torch's w8a8 INT8 path held against the JAX package on the CPU:
``build_quant_variables(..., mode='w8a8')``, the w8a8 ``QuantConv2d`` and
its ``odtk::conv_w8a8`` operator (the plain version here, the CUDA kernel
on the card: ``tests/test_torch_kernels.py``), the heads, and an engine
exported from a w8a8 model.

The JAX side runs op by op (``module.apply`` and ``heads_fn`` unjitted, as
``tests/test_quantize.py`` runs them), so its division by ``act_scale``
and its rescale are single IEEE operations as the port's are, with no
constant folded into a reciprocal and no fused multiply-add. The int8
convolution is exact in both, so a layer given the same input gives the
same output bit for bit. Across a whole network the two frameworks' fp32
activations (batch norm, residual sums, upsampling) can differ by an ulp,
and an ulp at a code's .5 boundary flips the code: such flips then spread
through the later layers, and the heads are compared to a stated bound.
"""

import copy
import io
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from odtk_tpu import quantize as jax_quantize
from odtk_tpu.backbones.layers import QuantConv
from odtk_tpu.io.torch_import import state_dict_to_variables
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import quantize
from odtk_tpu_torch.backbones.layers import QuantConv2d
from odtk_tpu_torch.export import Engine, export_cpp_engine, export_model
from odtk_tpu_torch.io.jax_bridge import module_name
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops.kernels import conv_w8a8 as kernel

from synth import make_dataset
from test_torch_export import CONFIG, images
from torch_threads import one_torch_thread  # noqa: F401

# act_scale = 31.75 / 127 = 0.25 exactly, so x = (k + 0.5) / 4 lands on a
# code's .5 boundary, where round half to even decides
HALF_WAY_ABSMAX = 31.75


def _codes_jax(x, act_scale):
    """The JAX QuantConv's codes (``odtk_tpu/backbones/layers.py:281``)."""
    return np.asarray(jnp.clip(jnp.round(x.astype(jnp.float32) / act_scale),
                               -127, 127).astype(jnp.int8))


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def _conv_pair(cin, cout, k, stride, groups, bias, seed):
    """A JAX QuantConv's w8a8 variables and the port's QuantConv2d built
    from the same int8 weight and scales."""
    rng = np.random.RandomState(seed)
    wq = rng.randint(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    w_scale = (rng.rand(cout) * 0.01 + 1e-3).astype(np.float32)
    act_scale = np.float32(HALF_WAY_ABSMAX / 127.0)
    params = {'kernel': wq}
    conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=bias)
    if bias:
        params['bias'] = rng.randn(cout).astype(np.float32)
        conv.bias.data = torch.from_numpy(params['bias'])
    variables = {'params': params,
                 'quant': {'w_scale': w_scale, 'act_scale': act_scale}}
    port = QuantConv2d.from_conv(
        conv, torch.from_numpy(wq.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(w_scale), torch.tensor(act_scale))
    return variables, port


def _input(cin, seed):
    """[2, 13, 17, cin] NHWC: N(0, 3), 40 values on .5 code boundaries
    of both parities, a NaN, +inf and -inf."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 13, 17, cin) * 3).astype(np.float32)
    x.flat[:40] = (rng.randint(-600, 600, 40) + 0.5) * np.float32(
        HALF_WAY_ABSMAX / 127.0)
    x.flat[41], x.flat[42], x.flat[43] = np.nan, np.inf, -np.inf
    return x


# (cin, cout, kernel, stride, groups, bias): the stem's 7x7/s2 over 3
# channels (K = 147, not a multiple of 32), a 1x1, 3x3 at stride 1 and 2,
# and a depthwise conv (groups = C)
CONVS = {'7x7s2_c3': (3, 8, 7, 2, 1, False), '1x1': (16, 24, 1, 1, 1, True),
         '3x3s1': (16, 24, 3, 1, 1, True), '3x3s2': (20, 24, 3, 2, 1, False),
         'depthwise': (24, 24, 3, 1, 24, False),
         'depthwise_bias_s2': (40, 40, 3, 2, 40, True)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', list(CONVS))
def test_quant_conv_equals_jax(name, dtype):
    """One w8a8 QuantConv2d against the JAX QuantConv on the same input
    (planted .5 boundaries, NaN, +-inf), fp32 and bf16 compute: the int8
    codes equal, the outputs equal bit for bit (no ulp allowance: both
    divide and rescale as single rounded IEEE operations)."""
    cin, cout, k, stride, groups, bias = CONVS[name]
    variables, port = _conv_pair(cin, cout, k, stride, groups, bias, 1)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    x = jnp.asarray(_input(cin, 2)).astype(jdt)
    module = QuantConv(cout, (k, k), (stride, stride), [(k // 2, k // 2)] * 2,
                       bias, groups, dtype=jdt)
    want = np.asarray(module.apply(variables, x).astype(jnp.float32))
    xt = _nchw(x.astype(jnp.float32)).to(getattr(torch, dtype)).contiguous()
    np.testing.assert_array_equal(
        kernel.quantize_activations(xt, port.act_scale).permute(
            0, 2, 3, 1).numpy(),
        _codes_jax(x, variables['quant']['act_scale']))
    got = port(xt)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  want)


def test_fp32_input_under_autocast_gives_bf16():
    """``conv1`` of a bf16 model under autocast may get an fp32 input: the
    operator is not autocast, so the output dtype comes from autocast's
    state (bf16), as the JAX ``y.astype(self.dtype)``; equal to the JAX
    QuantConv at bf16 on that fp32 input."""
    variables, port = _conv_pair(3, 8, 7, 2, 1, False, 3)
    x = _input(3, 4)
    module = QuantConv(8, (7, 7), (2, 2), [(3, 3)] * 2, False,
                       dtype=jnp.bfloat16)
    want = np.asarray(module.apply(variables, jnp.asarray(x)).astype(
        jnp.float32))
    with torch.autocast('cpu', dtype=torch.bfloat16):
        got = port(_nchw(x).contiguous())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  want)
    assert port(_nchw(x).contiguous()).dtype == torch.float32


def _int64_reference(x, weight_oihw, w_scale, act_scale, bias, stride,
                     padding, groups):
    """The w8a8 convolution computed independently in numpy: codes by
    np.round (half to even) with NaN -> 0, im2col and an int64 matmul per
    group, then the rescale and bias in float32."""
    q = np.round(x.astype(np.float32) / np.float32(act_scale))
    q = np.where(np.isnan(q), 0, np.clip(q, -127, 127)).astype(np.int64)
    b, c, h, w = q.shape
    o, cin_g, kh, kw = weight_oihw.shape
    (sh, sw), (ph, pw) = stride, padding
    qp = np.pad(q, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    cols = np.stack([qp[:, :, r:r + sh * ho:sh, s:s + sw * wo:sw]
                     for r in range(kh) for s in range(kw)], 2)
    cols = cols.reshape(b, groups, cin_g * kh * kw, ho * wo)
    wg = weight_oihw.astype(np.int64).reshape(groups, o // groups, -1)
    acc = np.einsum('gok,bgkp->bgop', wg, cols).reshape(b, o, ho, wo)
    assert np.abs(acc).max() < 2 ** 31
    y = acc.astype(np.float32) * (np.float32(act_scale) * w_scale)[
        :, None, None]
    if bias is not None:
        y = y + bias[:, None, None]
    return y


# (b, c, h, w, o, kernel, stride, padding, groups, bias): odd sizes, a
# contraction over 2 x 2 x 37 (K = 148), groups of 3 channels, depthwise
PLAIN_CASES = [(1, 3, 15, 21, 5, 7, 2, 3, 1, False),
               (3, 37, 9, 11, 6, 2, 1, 0, 1, True),
               (2, 12, 10, 7, 8, 3, 2, 1, 4, True),
               (2, 9, 8, 13, 9, 3, 1, 1, 9, False),
               (1, 64, 5, 5, 70, 3, 2, 1, 1, True)]


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', PLAIN_CASES)
def test_plain_equals_int64(case, out_dtype):
    """``conv_w8a8_plain`` (float64 convolution of the codes) equal to an
    independent int64 computation, on odd shapes with NaN and +-inf
    inputs and saturating values: bit for bit in fp32, and the same
    rounding to bf16."""
    b, c, h, w, o, k, s, p, groups, bias = case
    rng = np.random.RandomState(sum(case[:8]))
    x = (rng.randn(b, c, h, w) * 40).astype(np.float32)
    x.flat[0], x.flat[3], x.flat[-1] = np.nan, np.inf, -np.inf
    wq = rng.randint(-127, 128, (o, c // groups, k, k)).astype(np.int8)
    w_scale = (rng.rand(o) * 0.01 + 1e-4).astype(np.float32)
    act_scale = np.float32(np.float32(37.0) / np.float32(127.0))
    bvec = rng.randn(o).astype(np.float32) if bias else None
    dt = getattr(torch, out_dtype)
    got = kernel.conv_w8a8_plain(
        torch.from_numpy(x), kernel.pack_weight(torch.from_numpy(wq)),
        torch.from_numpy(w_scale), torch.tensor(act_scale),
        None if bvec is None else torch.from_numpy(bvec), (s, s), (p, p),
        groups, dt)
    want = torch.from_numpy(_int64_reference(x, wq, w_scale, act_scale, bvec,
                                             (s, s), (p, p), groups)).to(dt)
    assert got.dtype == dt and got.shape == want.shape
    assert torch.equal(got, want)


def test_wrapper_and_from_conv_refuse():
    """The wrapper refuses what the kernel does not take (dtype, weight
    layout, scale shapes, a window larger than the padded input);
    ``from_conv`` refuses dilation; a mode other than w8a16 / w8a8
    raises."""
    x = torch.randn(1, 8, 6, 6)
    w = kernel.pack_weight(torch.ones(4, 8, 3, 3, dtype=torch.int8))
    s, a, pad = torch.ones(4), torch.tensor(0.1), (1, 1)
    assert kernel.conv_w8a8(x, w, s, a, None, (1, 1), pad, 1,
                            torch.float32).shape == (1, 4, 6, 6)
    for args in [(x.half(), w, s, a, pad, torch.float32),
                 (x, w[..., :8].contiguous(), s, a, pad, torch.float32),
                 (x, w.float(), s, a, pad, torch.float32),
                 (x, w, torch.ones(3), a, pad, torch.float32),
                 (x, w, s, torch.ones(1), pad, torch.float32),
                 (x[..., :1, :1], w, s, a, (0, 0), torch.float32),
                 (x, w, s, a, pad, torch.float16)]:
        xi, wi, si, ai, pi, dt = args
        with pytest.raises(ValueError):
            kernel.conv_w8a8(xi, wi, si, ai, None, (1, 1), pi, 1, dt)
    with pytest.raises(ValueError, match='dilation'):
        QuantConv2d.from_conv(nn.Conv2d(8, 4, 3, dilation=2),
                              torch.ones(4, 8, 3, 3, dtype=torch.int8),
                              torch.ones(4), torch.tensor(0.1))
    with pytest.raises(ValueError, match='mode'):
        quantize.build_quant_variables(nn.Conv2d(3, 3, 1), {'': 1.0},
                                       mode='w4a8')


# ------------------------------------------------------------ whole models

@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('calib')
    img_dir, _ = make_dataset(str(root), n_images=2, size=(96, 96))
    return sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))


def _jax_keys(variables):
    """{port module name: JAX table key} of every 4-D kernel."""
    keys = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif k == 'kernel' and np.ndim(v) == 4:
                keys[module_name('/'.join(path))] = '/'.join(path)

    walk(variables['params'], [])
    return keys


def _jax_twin(port):
    """The JAX model of ``port``'s backbone with ``port``'s weights, handed
    over by the JAX package's own torch importer into a template from
    ``jax.eval_shape`` (no JAX initialization to compile)."""
    jax_model = JaxModel(port.backbones, classes=3, config=CONFIG)
    shapes = jax.eval_shape(jax_model.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 3)))
    template = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), shapes)
    variables, report = state_dict_to_variables(
        {k: v.numpy() for k, v in port.module.state_dict().items()},
        template)
    assert not report['missing'] and not report['unmatched'], report
    jax_model.variables = variables
    return jax_model


def _models():
    """{name: (JAX model, port model) on the same weights}: ResNet18FPN
    and MobileNetV2FPN (17 depthwise convs), initialized by the port from a
    seed, the final cls / box head kernels redrawn at std 1.0 / 0.2 (so the
    heads are informative) and every frozen batch norm redrawn (var and
    scale in [0.5, 1.5), mean and bias N(0, 0.1)) by numpy; and 'default',
    ResNet18FPN as initialized, the model of the JAX package's own w8a8
    tests."""
    out = {}
    for seed, name in enumerate(('ResNet18FPN', 'MobileNetV2FPN')):
        port = Model(name, classes=3, config=CONFIG).initialize(seed)
        rng = np.random.RandomState(20 + seed)
        state = port.module.state_dict()
        for k, v in state.items():
            if k in ('cls_head.8.weight', 'box_head.8.weight'):
                std = 1.0 if k.startswith('cls') else 0.2
                v.copy_(torch.from_numpy(rng.randn(*v.shape) * std))
            elif k.rsplit('.', 1)[0] + '.running_var' in state:
                wide = k.endswith(('running_var', '.weight'))
                v.copy_(torch.from_numpy(rng.rand(*v.shape) + 0.5 if wide
                                         else rng.randn(*v.shape) * 0.1))
        out[name] = (_jax_twin(port), port)
    port = Model('ResNet18FPN', classes=3, config=CONFIG).initialize(0)
    out['default'] = (_jax_twin(port), port)
    return out


@pytest.fixture(scope='module')
def models():
    return _models()


# the calibrations: the three methods on the default ResNet18FPN, absmax
# on the two others (MobileNetV2FPN's 69 entropy sweeps take 12 s)
METHODS = {'default': (('absmax', {}), ('p99.5', dict(percentile=99.5)),
                       ('entropy', dict(entropy=True))),
           'ResNet18FPN': (('absmax', {}),),
           'MobileNetV2FPN': (('absmax', {}),)}


@pytest.fixture(scope='module')
def tables(models, files, tmp_path_factory):
    """The port's calibration tables (``METHODS``) of each model at
    96 x 96 on two JPEGs."""
    from odtk_tpu_torch.export import calibrate

    root = tmp_path_factory.mktemp('tables')
    out = {}
    for name, (_, port) in models.items():
        for method, kw in METHODS[name]:
            out[name, method] = calibrate(
                port, (96, 96), files,
                calibration_table=str(root / f'{name}_{method}.json'),
                **kw)['act_absmax']
    return out


@pytest.mark.parametrize('name, method', [
    (name, method) for name, methods in METHODS.items()
    for method, _ in methods])
def test_act_scales_and_stats_equal_jax(models, tables, name, method):
    """``act_scale`` of every layer equal to the JAX package's
    ``qvars['quant'][...]['act_scale']`` from the same table (a Python
    float division rounded to fp32), the int8 weights equal after the
    layout change, and the same stats."""
    jax_model, port = models[name]
    table = tables[name, method]
    keys = _jax_keys(jax_model.variables)
    qvars, jstats = jax_quantize.build_quant_variables(
        jax_model.variables, {keys[k]: v for k, v in table.items()},
        mode='w8a8')
    module, stats = quantize.build_quant_variables(
        copy.deepcopy(port.module), table, mode='w8a8')
    assert stats == jstats
    convs = {n: m for n, m in module.named_modules()
             if isinstance(m, QuantConv2d)}
    assert sorted(convs) == sorted(table)
    for name_, conv in convs.items():
        node, qnode = qvars['params'], qvars['quant']
        for part in keys[name_].split('/'):
            node, qnode = node[part], qnode[part]
        assert conv.act_scale.dtype == torch.float32
        assert conv.act_scale.item() == qnode['act_scale'], name_
        want = np.asarray(node['kernel']).transpose(3, 0, 1, 2)
        np.testing.assert_array_equal(
            kernel.unpack_weight(conv.weight, want.shape[-1]).permute(
                0, 2, 3, 1).numpy(), want)
        assert not conv.weight[..., want.shape[-1]:].any()
        assert conv.weight.shape[-1] == kernel.padded(want.shape[-1])
        np.testing.assert_array_equal(conv.w_scale.numpy(), qnode['w_scale'])


@pytest.mark.parametrize('method', ['absmax', 'p99.5', 'entropy'])
def test_heads_within_jax_rule_of_fp32(models, tables, method):
    """The JAX package's behaviour rule (``tests/test_quantize.py:135``) on
    its model, ResNet18FPN as initialized, at 96 px: w8a8 heads within a
    mean abs 2e-2 of the fp32 heads, for each table."""
    _, port = models['default']
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 96, 96, 3).astype(np.float32))
    ref = torch.sigmoid(port.forward_heads(x)[0][0])
    w8a8 = copy.deepcopy(port)
    quantize.build_quant_variables(w8a8.module, tables['default', method],
                                   mode='w8a8')
    out = torch.sigmoid(w8a8.forward_heads(x)[0][0])
    assert torch.isfinite(out).all()
    assert (out - ref).abs().mean() < 2e-2


def _run_both(jax_model, port, qvars, x):
    """JAX heads_fn on the w8a8 variables and the port's heads, each with
    every quantized conv's inputs and outputs recorded (NHWC numpy, by
    port module name)."""
    keys = {v: k for k, v in _jax_keys(jax_model.variables).items()}
    jax_io, port_io = {}, {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, QuantConv) and \
                context.method_name == '__call__':
            jax_io.setdefault(keys['/'.join(context.module.path)], []).append(
                (np.asarray(args[0], np.float32), np.asarray(out)))
        return out

    with flax_nn.intercept_methods(intercept):
        want = jax_model.heads_fn(qvars, jnp.asarray(x))

    def hook(name):
        def fn(module, args, out):
            port_io.setdefault(name, []).append(
                (args[0].float().permute(0, 2, 3, 1).numpy(),
                 out.permute(0, 2, 3, 1).numpy()))
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in port.module.named_modules()
               if isinstance(m, QuantConv2d)]
    try:
        cls, box = port.forward_heads(torch.from_numpy(x))
    finally:
        for h in handles:
            h.remove()
    got = [torch.sigmoid(c.float()).numpy() for c in cls] + \
        [b.numpy() for b in box]
    return got, [np.asarray(w) for w in want[0] + want[1]], jax_io, port_io


@pytest.fixture(scope='module')
def heads(models, tables):
    """Per model: the absmax w8a8 heads of both packages at 96 px (port,
    JAX), the fp32 JAX heads, the conv inputs and outputs of both, and the
    port's w8a8 model."""
    out = {}
    x = images(1, seed=5, size=96)
    for name in ('ResNet18FPN', 'MobileNetV2FPN'):
        jax_model, port = models[name]
        table = tables[name, 'absmax']
        keys = _jax_keys(jax_model.variables)
        qvars, _ = jax_quantize.build_quant_variables(
            jax_model.variables, {keys[k]: v for k, v in table.items()},
            mode='w8a8')
        w8a8 = copy.deepcopy(port)
        quantize.build_quant_variables(w8a8.module, table, mode='w8a8')
        got, want, jax_io, port_io = _run_both(jax_model, w8a8, qvars, x)
        fp32 = [np.asarray(h) for h in sum(
            jax_model.heads_fn(jax_model.variables, jnp.asarray(x)), [])]
        out[name] = dict(got=got, want=want, fp32=fp32, jax_io=jax_io,
                         port_io=port_io, model=w8a8, x=x)
    return out


@pytest.mark.parametrize('name', ['ResNet18FPN', 'MobileNetV2FPN'])
def test_every_conv_on_jax_inputs_equals_jax(heads, name):
    """Each w8a8 conv of the port given the input that the JAX package's
    conv got in its own forward (every call: 38 / 69 layers, the heads at
    five levels) returns the JAX conv's output bit for bit."""
    h = heads[name]
    convs = dict(h['model'].module.named_modules())
    assert sorted(h['jax_io']) == sorted(h['port_io'])
    calls = 0
    for layer, pairs in h['jax_io'].items():
        for x, y in pairs:
            got = convs[layer](_nchw(x).contiguous()).permute(0, 2, 3, 1)
            if got.shape != y.shape:
                # the JAX stem's merged-phase layout ([B, Ho, Wo / 2, 2O],
                # even then odd output columns) to plain NHWC
                b, ho, wo, o = got.shape
                y = y.reshape(b, ho, wo // 2, 2, o).reshape(b, ho, wo, o)
            np.testing.assert_array_equal(got.numpy(), y, err_msg=layer)
            calls += 1
    assert calls == {'ResNet18FPN': 78, 'MobileNetV2FPN': 109}[name]


# Heads of the port's w8a8 model against ``heads_fn`` on the JAX w8a8
# variables at 96 px. Measured on the CPU with these weights and input: no
# code of either model flips, and the heads differ by at most 6.0e-8
# (ResNet18FPN) and 1.9e-9 (MobileNetV2FPN), the sigmoid of equal logits
# taken by two libraries. The fp32 activations between the convs (batch
# norm, residual sums, upsampling) may still differ by an ulp, and an ulp
# at a .5 boundary flips a code that then moves later layers; so the bound
# is not equality: the port's mean gap to JAX w8a8 within 2x the JAX w8a8
# heads' own mean gap to fp32 (5.8e-3 / 7.8e-5 on the first level's cls
# head), each element within 5% of the head's scale, and a flip one code.
@pytest.mark.parametrize('name', ['ResNet18FPN', 'MobileNetV2FPN'])
def test_heads_match_jax_w8a8(heads, name):
    """The port's w8a8 heads against the JAX package's at 96 px, and the
    share of flipped codes per layer: zero up to the first layer whose
    inputs differ by more than fp32 rounding, one code a flip."""
    h = heads[name]
    gaps = []
    for got, want, fp32 in zip(h['got'], h['want'], h['fp32']):
        gaps.append((float(np.abs(got - want).max()),
                     float(np.abs(want - fp32).mean())))
        assert np.isfinite(got).all()
        noise = np.abs(want - fp32).mean()
        assert np.abs(got - want).mean() <= 2 * noise + 1e-9
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max() + 1e-9
    convs = dict(h['model'].module.named_modules())
    shares, first = {}, None
    for layer, pairs in h['jax_io'].items():      # in the forward's order
        scale = convs[layer].act_scale.numpy()
        flips = total = 0
        for (xj, _), (xp, _) in zip(pairs, h['port_io'][layer]):
            cj = _codes_jax(jnp.asarray(xj), scale).astype(np.int32)
            cp = _codes_jax(jnp.asarray(xp), scale)
            assert np.abs(cj - cp).max() <= 1, layer
            if first is None and (cj != cp).any():
                # the first flip: inputs apart by fp32 rounding only
                first = layer
                ulp = np.spacing(np.float32(np.abs(xj).max()))
                assert np.abs(xj - xp).max() <= 4 * ulp, layer
            flips += int((cj != cp).sum())
            total += cj.size
        shares[layer] = flips / total
    print(f'{name}: heads (max gap to JAX w8a8, JAX w8a8 mean gap to fp32) '
          f'{gaps}; share of flipped codes per layer (first at {first}) '
          f'{shares}')
    if name == 'ResNet18FPN':
        assert first is None


def _program_code(engine, batch):
    program = torch.export.load(io.BytesIO(engine.blobs[str(batch)]))
    return '\n'.join(m.code for m in program.graph_module.modules()
                     if hasattr(m, 'code'))


@pytest.mark.parametrize('precision', ['bf16', 'fp32'])
def test_w8a8_engine_equals_model(heads, precision, tmp_path):
    """An engine exported from the w8a8 model (``export_model`` at bf16 or
    fp32 over the swapped module, the JAX ``export_model`` over w8a8
    variables): ``odtk::conv_w8a8`` in its program, the ``act_scale``
    buffers in its weights through a save and load, its detections equal
    to the model's own inference bit for bit, and ``export_cpp_engine``
    refusing the model."""
    model = copy.deepcopy(heads['ResNet18FPN']['model'])
    path = str(tmp_path / 'w8a8.engine')
    export_model(model, (128, 128), precision=precision, path=path,
                 dynamic_batch_opts=[1, 1, 1])
    engine = Engine.load(path)
    code = _program_code(engine, 1)
    assert 'odtk.conv_w8a8' in code and 'aten.convolution' not in code
    scales = {k: v for k, v in engine.variables.items()
              if k.endswith('act_scale')}
    want = {f'{n}.act_scale': m.act_scale for n, m in
            model.module.named_modules() if isinstance(m, QuantConv2d)}
    assert len(scales) == len(want) == 38
    assert all(torch.equal(scales[k], want[k]) for k in want)
    x = images(1, seed=3)
    got = engine(x)
    model.set_dtype(torch.bfloat16 if precision == 'bf16' else torch.float32)
    ref = model.inference_fn(torch.from_numpy(x))
    assert float(got[0].max()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match='w8a8'):
        export_cpp_engine(model, (128, 128),
                          path=str(tmp_path / 'm.cppengine'))
