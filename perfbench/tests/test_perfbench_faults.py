"""``correct`` comes out false when the timed path is broken underneath,
and when the control (the reference in fp8) stands in the program's
place: the whole run past the look for a card, on the CPU at a small
size, with each cell's own limits."""

import pytest
import torch

from perfbench import control
from perfbench.lib import cell as cells
from perfbench.lib import judge
from perfbench.tests.small import small

SEED = 2 ** 31 + 3


def _correct(name, out):
    return judge.verdict(out['numbers'], cells.resolve(name)['limits'])[0]


def _run(name):
    return cells.run(small(name), SEED, 0.5, False, 'cpu', 0.0)


@pytest.mark.parametrize('name', ['r50fpn-train-b8', 'mnv2fpn-train-b8',
                                  'r50fpn-infer-b8'])
def test_sound_run_is_correct(name):
    assert _correct(name, _run(name))


@pytest.mark.parametrize('name', ['r50fpn-train-b8', 'mnv2fpn-train-b8'])
def test_state_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, 'step',
                        lambda self, closure=None: None)
    out = _run(name)
    assert out['numbers']['update_gap'] > 0.99
    assert not _correct(name, out)


def test_first_blocks_unmoved(monkeypatch):
    """The optimizer skips MobileNetV2's blocks 0-6 (its first 18 of 87
    leaves): the median leaf does not see it, the 90th percentile does."""
    step = torch.optim.SGD.step

    def skip_first(self, closure=None):
        for p in self.param_groups[0]['params'][:18]:
            p.grad = None
        return step(self, closure)

    monkeypatch.setattr(torch.optim.SGD, 'step', skip_first)
    name = 'mnv2fpn-train-b8'
    out = _run(name)
    limits = cells.resolve(name)['limits']
    assert out['numbers']['update_gap_median'] < limits['update_gap_median']
    assert out['numbers']['update_gap_q90'] > limits['update_gap_q90']
    assert not _correct(name, out)


@pytest.mark.parametrize('name', ['r50fpn-train-b8', 'mnv2fpn-train-b8'])
def test_half_batch_left_out(name, monkeypatch):
    from odtk_tpu_torch.model import Model

    loss_fn = Model.loss_fn

    def half(self, images, targets):
        n = images.shape[0] // 2
        return loss_fn(self, images[:n], targets[:n])

    monkeypatch.setattr(Model, 'loss_fn', half)
    assert not _correct(name, _run(name))


def test_answer_altered(monkeypatch):
    from odtk_tpu_torch.model import Model

    infer = Model.inference_fn_u8

    def altered(self, images, sizes):
        scores, boxes, classes = infer(self, images, sizes)
        classes = classes.clone()
        classes[0, 0] = (classes[0, 0] + 1) % self.classes
        return scores, boxes, classes

    monkeypatch.setattr(Model, 'inference_fn_u8', altered)
    assert not _correct('r50fpn-infer-b8', _run('r50fpn-infer-b8'))


def test_short_list(monkeypatch):
    """The NMS returns only the first half of its detections: the
    candidates that should have filled the rest read the selection gap."""
    import odtk_tpu_torch.model as program

    nms = program.nms

    def short(*args, **kwargs):
        scores, boxes, classes = nms(*args, **kwargs)
        half = scores.shape[1] // 2
        return scores.index_fill(1, torch.arange(
            half, scores.shape[1], device=scores.device), 0.0), boxes, classes

    monkeypatch.setattr(program, 'nms', short)
    out = _run('r50fpn-infer-b8')
    limits = cells.resolve('r50fpn-infer-b8')['limits']
    assert out['numbers']['select_gap'] > limits['select_gap']
    assert not _correct('r50fpn-infer-b8', out)


@pytest.mark.parametrize('name', ['r50fpn-train-b8', 'mnv2fpn-train-b8'])
def test_training_control_fails(name):
    got = control.train_readings(small(name), SEED, torch.device('cpu'))
    assert not judge.verdict(got['control'],
                             cells.resolve(name)['limits'])[0]


def test_serving_control_fails():
    name = 'r50fpn-infer-b8'
    got = control.serve_readings(small(name), SEED, torch.device('cpu'))
    limits = cells.resolve(name)['limits']
    for case in ('control', 'altered_class', 'moved_box', 'short_list'):
        assert not judge.verdict(got[case], limits)[0], case
