"""odtk_tpu_torch's other backbones on the port's own paths, on the CPU
(no JAX): the CLI trains, infers and exports them, their engines hold
the kernel operators exactly where the model runs them, fine-tuning
grafts a C4 backbone, and the loss and the
rotated matcher take more levels than one kernel launch holds (a model
of two FPN backbones has 10). The comparisons with the JAX package are
in ``tests/test_torch_backbones.py``.
"""

import io
import json

import numpy as np
import pytest
import torch

from odtk_tpu_torch import main as cli
from odtk_tpu_torch.export import export_model
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops import generate_anchors_rotated, rotate_boxes
from odtk_tpu_torch.ops.assign import level_anchors
from odtk_tpu_torch.ops.iou_rotated import match_inputs_levels
from odtk_tpu_torch.ops.kernels import _build
from odtk_tpu_torch.ops.kernels import loss as kloss
from odtk_tpu_torch.ops.kernels import match_rotated as kmatch

from synth import make_dataset
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
SIZE = 128
MODELS = {'mobilenet': ('MobileNetV2FPN',), 'c4': ('ResNet18C4',),
          'pair': ('ResNet18FPN', 'MobileNetV2FPN')}


def graph_code(engine, batch):
    """The Python code of one profile's program, its autocast regions
    included."""
    program = torch.export.load(io.BytesIO(engine.blobs[str(batch)]))
    return '\n'.join(m.code for m in program.graph_module.modules()
                     if hasattr(m, 'code'))


@pytest.mark.parametrize('key, stem', [('mobilenet', False), ('c4', True),
                                       ('pair', True)])
def test_engine_holds_the_stem_op_where_the_model_runs_it(key, stem):
    """An fp32 engine at 128 x 128: the program holds ``odtk::nms``, and
    ``odtk::bn_relu_pool`` exactly when a backbone has the ResNet stem
    (MobileNetV2FPN's stem is a plain ConvBNReLU6); the engine equals the
    checkpoint path within 1e-6."""
    model = Model(list(MODELS[key]), classes=CLASSES,
                  config={'threshold': 0.001}).initialize(5)
    engine = export_model(model, (SIZE, SIZE), precision='fp32',
                          dynamic_batch_opts=[2])
    code = graph_code(engine, 2)
    assert code.count('torch.ops.odtk.nms.default') == 1
    assert code.count('torch.ops.odtk.bn_relu_pool.default') == int(stem)
    x = torch.from_numpy((np.random.RandomState(6).randn(
        2, SIZE, SIZE, 3) * 0.5).astype(np.float32))
    got, want = engine(x), model.inference_fn(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize('backbone', ['ResNet18C4', 'MobileNetV2FPN'])
def test_cli_train_infer_export_on_the_cpu(backbone, tmp_path):
    """``odtk-tpu-torch train --backbone`` takes a step on the CPU, and
    ``infer`` scores the checkpoint and the engine ``export`` writes from
    it, with finite detections of the model's classes."""
    img_dir, ann = make_dataset(str(tmp_path), n_images=2, size=(96, 128),
                                fmt='jpg')
    ckpt, engine = str(tmp_path / 'm.pth'), str(tmp_path / 'm.engine')
    common = ['--images', img_dir, '--annotations', ann, '--device', 'cpu']
    result = cli.main(['train', ckpt, '--backbone', backbone, '--classes',
                       '3', '--iters', '1', '--warmup', '1', '--milestones',
                       '1', '--batch', '2', '--resize', '96', '--max-size',
                       '128', '--jitter', '96', '96', '--full-precision',
                       '--no-pretrained', *common])
    assert len(result['losses']) == 1
    assert np.isfinite(result['losses'][0][1:]).all()
    assert Model.load(ckpt)[0].backbones == [backbone]
    cli.main(['export', ckpt, engine, '--size', '128', '--threshold',
              '0.001', '--dynamic-batch-opts', '2', '2', '2',
              '--full-precision', '--device', 'cpu'])
    for path in (ckpt, engine):
        det = str(tmp_path / 'det.json')
        out = cli.main(['infer', path, '--output', det, '--batch', '2',
                        '--resize', '96', '--max-size', '128', '--threshold',
                        '0.001', *common])
        assert len(out['batch_ms']) == 1
        with open(det) as f:
            dets = json.load(f)['annotations']
        assert dets and all(d['category_id'] in (1, 2, 3) for d in dets)
        assert all(np.isfinite(d['bbox'] + [d['score']]).all() for d in dets)


def test_fine_tune_grafts_a_c4_backbone(tmp_path):
    """``fine_tune`` from a C4 donor copies the whole backbone group and
    the head convs but the final class conv; a donor of another backbone
    grafts no backbone tensor."""
    donor = Model('ResNet18C4', classes=CLASSES).initialize(1)
    path = str(tmp_path / 'donor.pth')
    donor.save({'path': path})
    own = Model('ResNet18C4', classes=CLASSES + 1).initialize(
        2, fine_tune=path).module.state_dict()
    fresh = Model('ResNet18C4', classes=CLASSES + 1).initialize(
        2).module.state_dict()
    src = donor.module.state_dict()
    for k, v in own.items():
        if k.startswith(('backbones.', 'box_head.', 'cls_head.0')):
            torch.testing.assert_close(v, src[k], rtol=0, atol=0)
        elif k.startswith('cls_head.8'):
            torch.testing.assert_close(v, fresh[k], rtol=0, atol=0)
    other = Model('MobileNetV2FPN', classes=CLASSES).initialize(
        3, fine_tune=path).module.state_dict()
    plain = Model('MobileNetV2FPN', classes=CLASSES).initialize(
        3).module.state_dict()
    for k in other:
        if k.startswith('backbones.'):
            torch.testing.assert_close(other[k], plain[k], rtol=0, atol=0)


def _loss_levels(rng, n_levels):
    """Per-level loss operands of a b=2, 9-anchor, 3-class model, level l
    of (4 - l % 3) x (5 - l % 2) positions."""
    levels = []
    for level in range(n_levels):
        h, w = 4 - level % 3, 5 - level % 2
        n = h * w * 9
        cls = rng.randint(0, CLASSES, (2, n))
        depth = rng.choice([-1.0, 0.0, 0.0], (2, n))
        fg = rng.rand(2, n) < 0.1
        depth[fg] = cls[fg] + 1
        levels.append([torch.from_numpy(a) for a in (
            (rng.randn(2, h, w, 9 * CLASSES) * 3).astype(np.float32),
            (rng.randn(2, h, w, 36) * 0.3).astype(np.float32),
            cls.astype(np.int32), (rng.randn(2, n, 4) * 0.3).astype(
                np.float32), depth.astype(np.float32))])
    return levels


@pytest.mark.parametrize('n', [1, 5, 8, 9, 10, 16, 17])
def test_level_groups_take_every_level_once(n):
    """``level_groups`` cuts n levels, in order, into the fewest launches
    of at most ``MAX_LEVELS`` (the same 8 for the loss and the matcher),
    each level in exactly one."""
    assert kloss.MAX_LEVELS == kmatch.MAX_LEVELS == 8
    cuts = _build.level_groups(n, kloss.MAX_LEVELS)
    assert len(cuts) == -(-n // 8)
    taken = [i for cut in cuts for i in range(n)[cut]]
    assert taken == list(range(n))
    assert all(0 < len(range(n)[cut]) <= 8 for cut in cuts)


def test_ten_levels_equal_the_levels_one_at_a_time():
    """``detection_loss_sums_levels`` and ``rotated_match_levels`` take
    more levels than one kernel launch holds (``MAX_LEVELS``): 10 levels
    give each level's sums and gradients, and each level's best matches,
    exactly as the level alone does."""
    assert 10 > kloss.MAX_LEVELS and 10 > kmatch.MAX_LEVELS
    levels = _loss_levels(np.random.RandomState(7), 10)
    heads = [t.clone().requires_grad_(True) for lv in levels for t in lv[:2]]
    sums = kloss.detection_loss_sums_levels(
        heads[0::2], heads[1::2], *([lv[i] for lv in levels]
                                    for i in (2, 3, 4)), CLASSES)
    assert sums.shape == (10, 2)
    g = torch.from_numpy(np.random.RandomState(8).rand(10, 2).astype(
        np.float32))
    grads = torch.autograd.grad((sums * g).sum(), heads)
    for i, lv in enumerate(levels):
        one = [t.clone().requires_grad_(True) for t in lv[:2]]
        want = kloss.detection_loss_sums_levels(
            [one[0]], [one[1]], [lv[2]], [lv[3]], [lv[4]], CLASSES)
        torch.testing.assert_close(sums[i], want[0], rtol=0, atol=0)
        want_g = torch.autograd.grad((want[0] * g[i]).sum(), one)
        for got_t, want_t in zip(grads[2 * i:2 * i + 2], want_g):
            torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)

    table = generate_anchors_rotated(16, [1.0, 2.0, 0.5], [4.0, 5.04],
                                     [-0.5, 0.0, 0.5])
    quads = [level_anchors(6 - level % 3, 5, 16, table[1],
                           torch.device('cpu')) for level in range(10)]
    rng = np.random.RandomState(9)
    boxes = np.concatenate([rng.uniform(0, 60, (2, 5, 2)),
                            rng.uniform(20, 80, (2, 5, 2)),
                            rng.uniform(-1, 1, (2, 5, 1))], -1)
    corners = rotate_boxes(torch.from_numpy(boxes.astype(np.float32)))[1]
    valid = torch.from_numpy(rng.rand(2, 5) < 0.8)
    subj, rows, n_act = match_inputs_levels(quads, corners, valid, 0.4)
    got = kmatch.rotated_match_levels(subj, rows, n_act)
    assert len(got) == 10
    for level, (iou, slot) in enumerate(got):
        w_iou, w_slot = kmatch.rotated_match_levels(
            subj[level:level + 1], rows[level:level + 1],
            n_act[level:level + 1])[0]
        assert torch.equal(iou, w_iou) and torch.equal(slot, w_slot)
    assert any(bool((iou > 0).any()) for iou, _ in got)
