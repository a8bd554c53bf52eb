"""odtk_tpu_torch model, checkpoints and CLI held against the JAX package.

One JAX ResNet18FPN model (4 classes) is initialized per module; its
weights reach the port through the weight bridge or a ``.pth`` file, and
both run the same numpy inputs on the CPU in fp32.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from odtk_tpu.io import checkpoint as jax_checkpoint
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_model():
    model = JaxModel('ResNet18FPN', classes=4)
    model.initialize(rng=0)
    model.variables = jax.tree.map(np.asarray, model.variables)
    return model


def _port_from_jax(variables, config=None):
    model = Model('ResNet18FPN', classes=4, config=config)
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_weight_bridge_matches_jax_export(jax_model):
    sd = state_dict_from_jax(jax_model.variables)
    _assert_state_dicts_equal(sd, variables_to_state_dict(jax_model.variables))
    port = Model('ResNet18FPN', classes=4)
    port.module.load_state_dict(sd, strict=True)
    _assert_state_dicts_equal(port.module.state_dict(), sd)


def test_checkpoint_written_by_jax_loads_in_port(jax_model, tmp_path):
    path = str(tmp_path / 'jax.pth')
    jax_model.save({'path': path, 'iteration': 7,
                    'optimizer': {'mu': np.arange(3.0, dtype=np.float32)}})
    port, state = Model.load(path)
    _assert_state_dicts_equal(port.module.state_dict(),
                              variables_to_state_dict(jax_model.variables))
    assert state['iteration'] == 7
    assert isinstance(state['optimizer'], bytes)
    assert port.ratios == jax_model.ratios and port.scales == jax_model.scales


def test_checkpoint_written_by_port_loads_in_jax(tmp_path):
    path = str(tmp_path / 'port.pth')
    port = Model('ResNet18FPN', classes=4).initialize(
        torch.Generator().manual_seed(5))
    port.save({'path': path, 'iteration': 3})
    restored, state = jax_checkpoint.load(path)
    assert state['iteration'] == 3
    assert restored.backbones == ['ResNet18FPN'] and restored.classes == 4
    _assert_state_dicts_equal(variables_to_state_dict(restored.variables),
                              port.module.state_dict())


def test_random_init_is_seeded():
    a, b = (Model('ResNet18FPN', classes=4).initialize(
        torch.Generator().manual_seed(1)) for _ in range(2))
    _assert_state_dicts_equal(a.module.state_dict(), b.module.state_dict())
    bias = a.module.state_dict()['cls_head.8.bias']
    np.testing.assert_allclose(bias.numpy(), -np.log(99.0), rtol=1e-6)


def test_heads_match_jax(jax_model):
    """Per-level heads on 2 x 128x128 images, fp32: atol 1e-4 x max|head|
    (the convolutions sum in another order)."""
    x = np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32)
    want_cls, want_box = jax_model.module.apply(jax_model.variables, x)
    got_cls, got_box = _port_from_jax(jax_model.variables).forward_heads(
        torch.from_numpy(x))
    assert len(got_cls) == len(want_cls) == 5
    for got, want in zip(got_cls + got_box, want_cls + want_box):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def _spread_heads(variables, seed=0):
    """A copy of ``variables`` whose final cls/box conv weights are drawn
    with numpy at a std that spreads the logits over several units: at
    the 0.01 init every score sits at ~0.0100 and conv-order noise would
    reorder near-ties."""
    rng = np.random.RandomState(seed)
    params = dict(variables['params'])
    for name, std in (('cls_head_8', 1.0), ('box_head_8', 0.2)):
        kernel = params[name]['kernel']
        params[name] = dict(params[name], kernel=(
            rng.randn(*kernel.shape) * std).astype(np.float32))
    return dict(variables, params=params)


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


@pytest.mark.parametrize('decode_fused', [True, False])
def test_inference_fn_u8_matches_jax(jax_model, decode_fused):
    """The whole slice (normalize, backbone, FPN, heads, decode, NMS) on
    the same weights, fp32, threshold 0.001. Detections matched by
    (class, score): scores atol 1e-5, boxes atol 1e-2 px."""
    variables = _spread_heads(jax_model.variables)
    config = {'threshold': 0.001, 'decode_fused': decode_fused}
    jax_ref = JaxModel('ResNet18FPN', classes=4, config=config)
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    sizes = np.asarray([[128, 128], [100, 120]], np.float32)
    want = jax.jit(jax_ref.inference_fn_u8)(variables, u8, sizes)
    got = _port_from_jax(variables, config).inference_fn_u8(
        torch.from_numpy(u8), torch.from_numpy(sizes))
    for i in range(2):
        g = _by_class_score(*(t[i].numpy() for t in got))
        w = _by_class_score(*(np.asarray(t[i]) for t in want))
        assert len(g[0]) == len(w[0]) > 10
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-2)


def test_cli_infer_on_cpu(tmp_path):
    img_dir, ann = make_dataset(str(tmp_path), n_images=4, size=(96, 128),
                                fmt='jpg')
    ckpt = str(tmp_path / 'model.pth')
    Model('ResNet18FPN', classes=3).initialize(0).save({'path': ckpt})
    out = str(tmp_path / 'detections.json')
    result = cli.main(['infer', ckpt, '--images', img_dir, '--annotations',
                       ann, '--output', out, '--batch', '2', '--resize',
                       '96', '--max-size', '128', '--threshold', '0.001',
                       '--device', 'cpu'])
    with open(out) as f:
        dets = json.load(f)
    assert result['stats'] is not None
    assert len(result['batch_ms']) == 2
    assert {d['image_id'] for d in dets['annotations']} == {0, 1, 2, 3}
    for d in dets['annotations']:
        assert d['category_id'] in (1, 2, 3) and len(d['bbox']) == 4
        assert all(np.isfinite(d['bbox'])) and 0.001 < d['score'] < 1


def test_cli_cuda_device_needs_a_card(tmp_path, monkeypatch):
    ckpt = str(tmp_path / 'model.pth')
    Model('ResNet18FPN', classes=3).save({'path': ckpt})
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['infer', ckpt, '--images', str(tmp_path)])


def test_port_never_imports_jax():
    code = ('import sys\n'
            'before = set(sys.modules)\n'
            'import odtk_tpu_torch, odtk_tpu_torch.main\n'
            'import odtk_tpu_torch.infer, odtk_tpu_torch.model\n'
            'import odtk_tpu_torch.backbones.mobilenet\n'
            'import odtk_tpu_torch.backbones.resnet\n'
            'import odtk_tpu_torch.io.checkpoint\n'
            'import odtk_tpu_torch.io.jax_bridge\n'
            'import odtk_tpu_torch.io.model_zoo\n'
            'import odtk_tpu_torch.profile_infer\n'
            'import odtk_tpu_torch.profile_engine\n'
            'import odtk_tpu_torch.profile_stem\n'
            'import odtk_tpu_torch.profile_kernels\n'
            'import odtk_tpu_torch.profile_train, odtk_tpu_torch.train\n'
            'import odtk_tpu_torch.data, odtk_tpu_torch.utils\n'
            'import odtk_tpu_torch.export, odtk_tpu_torch.quantize\n'
            'new = {m.split(".")[0] for m in set(sys.modules) - before}\n'
            'print(sorted(new & {"jax", "flax", "jaxlib", "optax",\n'
            '                    "odtk_tpu"}))\n')
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_profile_stem_needs_a_card(monkeypatch):
    """The stem's timing script measures on a card or fails: it has no
    CPU fallback."""
    from odtk_tpu_torch import profile_stem
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        profile_stem.main([])


def test_profile_kernels_needs_a_card(monkeypatch):
    """Rows 6 and 8's timing script measures on a card or fails."""
    from odtk_tpu_torch import profile_kernels
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        profile_kernels.main([])


def test_profile_kernels_counts_vector_loops_and_p3_pairs():
    """The SASS count takes each backward branch's span that holds 16-byte
    loads, NOPs left out; the row 8 case is P3 of the 896 x 1152 canvas
    (435,456 anchors) against 7 valid rows of 128, whose pair counts the
    script prints beside the bound."""
    from odtk_tpu_torch import profile_kernels as pk
    sass = [(0x10, 'MOV R1, R2'), (0x20, 'LDG.E.128.CONSTANT R4, [R2]'),
            (0x30, 'FFMA R5, R4, R4, R5'), (0x40, 'NOP'),
            (0x50, '@P0 BRA 0x20'), (0x60, 'LDG.E R4, [R2]'),
            (0x70, 'BRA 0x60'), (0x80, 'EXIT')]
    assert pk.vector_loops(sass) == [(3, 1)]
    anchors, clips, valid = pk.p3_match_case('cpu')
    assert anchors.shape == (435456, 8) and clips.shape == (128, 8)
    assert valid.sum() == 7 and valid[:7].all()
    every, overlap, widened = pk.match_pairs(anchors, clips, valid)
    assert every == 435456 * 7 and 0 < overlap <= widened < every // 10


@pytest.mark.parametrize('name, fam', [
    ('void (anonymous namespace)::nms_kernel<2>(float const*', 'nms kernel'),
    ('(anonymous namespace)::nms_rotated_kernel(float const*, float',
     'rotated nms kernel'),
    ('(anonymous namespace)::nms_mask_kernel(float const*, float const*',
     'rotated nms kernel'),
    ('(anonymous namespace)::nms_scan_kernel(unsigned long long const*',
     'rotated nms kernel'),
    ('void (anonymous namespace)::match_kernel<true>(float const*',
     'rotated matcher kernel'),
    ('void (anonymous namespace)::nms_axis_mask_kernel(float const*, float',
     'nms kernel'),
    ('void (anonymous namespace)::nms_count_kernel<4>(float const*, int',
     'nms kernel'),
    ('void (anonymous namespace)::nms_order_kernel<4>(float const*, int',
     'nms kernel'),
    ('void (anonymous namespace)::nms_scan_kernel<4>(float const*, float',
     'nms kernel'),
    ('void (anonymous namespace)::nms_count_kernel<6>(float const*, int',
     'rotated nms kernel'),
    ('void (anonymous namespace)::nms_scan_kernel<6>(float const*, float',
     'rotated nms kernel'),
    ('(anonymous namespace)::match_levels_kernel((anonymous namespace)::Ta',
     'rotated matcher kernel'),
    ('(anonymous namespace)::best_match_kernel(float const*, float const*',
     'rotated matcher kernel'),
    ('void (anonymous namespace)::det_loss_bwd_kernel<__nv_bfloat16>',
     'det_loss kernel'),
    ('void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>',
     'conv / GEMM math'),
    ('void (anonymous namespace)::stem_pool_kernel<__nv_bfloat16>',
     'stem kernel'),
    ('void (anonymous namespace)::stem_pool_fwd_kernel<__nv_bfloat16, fals',
     'stem kernel'),
    ('void (anonymous namespace)::stem_pool_fwd_kernel<float, false>(float',
     'stem kernel'),
    ('void (anonymous namespace)::stem_pool_fwd_kernel<__nv_bfloat16, true>',
     'stem argmax forward kernel'),
    ('void (anonymous namespace)::stem_pool_fwd_kernel<float, true>(float c',
     'stem argmax forward kernel'),
    ('void (anonymous namespace)::stem_pool_idx_kernel<__nv_bfloat16>(__nv',
     'stem argmax forward kernel'),
    ('void (anonymous namespace)::stem_pool_bwd_kernel<float>(signed char',
     'stem backward kernel'),
    ('void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>',
     'conv layout transform'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc',
     'conv / GEMM math'),
    ('nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT', 'conv / GEMM math'),
    ('void at::native::(anonymous namespace)::conv_depthwise2d_forward_'
     'kernel<3, c10::BFloat16, int>', 'depthwise conv'),
    ('void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_'
     'kernel<c10::BFloat16, float, int>', 'depthwise conv'),
    ('void at::native::mbtopk::gatherTopK<c10::BFloat16, unsigned int>',
     'topk / sort'),
    ('Memset (Device)', 'memcpy / memset'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel',
     'elementwise'),
])
def test_profile_kernel_family(name, fam):
    from odtk_tpu_torch.profile_infer import family
    assert family(name) == fam


@pytest.mark.parametrize('name, short', [
    ('void (anonymous namespace)::nms_scan_kernel<4>(float const*, float',
     'nms_scan_kernel<4>'),
    ('(anonymous namespace)::match_levels_kernel((anonymous namespace)::Ta',
     'match_levels_kernel'),
    ('void odtk::stem_pool_kernel<__nv_bfloat16>(__nv_bfloat16 const*',
     'stem_pool_kernel<__nv_bfloat16>'),
])
def test_profile_kernel_short_name(name, short):
    """The per-kernel rows of the profiles name a kernel without its
    namespace, return type and arguments."""
    from odtk_tpu_torch.profile_infer import _short
    assert _short(name) == short
