"""odtk_tpu_torch's copy of the data pipeline held equal to odtk_tpu's.

The port imports nothing of ``odtk_tpu``; it keeps copies of the loader,
the dataset and the evaluator. For the same files and seeds the two
loaders must yield the same arrays, and the two evaluators the same
stats. Both loaders decode through the same route in each case: PIL
(native library off in both), or the same native library.
"""

import json
import os
import random
import threading

import numpy as np
import pytest

from odtk_tpu.data import CocoEvaluator as JaxEvaluator
from odtk_tpu.data import DataIterator as JaxIterator
from odtk_tpu_torch.data import CocoEvaluator, CocoIndex, DataIterator
from odtk_tpu_torch.data import native

from synth import make_dataset
from torch_decode_route import decode_route  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_data')
    return make_dataset(str(root), n_images=5, size=(100, 130), max_boxes=3,
                        seed=4, fmt='jpg')


def _batches(cls, img_dir, ann, random_seed, n, **kw):
    """One whole epoch of ``n`` batches. The augmentations draw from the
    global ``random`` in the loader's worker thread, so an iterator left
    with work queued would go on drawing while the next one runs."""
    it = cls(img_dir, num_threads=1, **kw)
    random.seed(random_seed)
    out = list(it)
    assert len(out) == n
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def test_eval_u8_batches_equal(dataset, decode_route):
    img_dir, ann = dataset
    kw = dict(resize=96, max_size=128, batch_size=2, stride=32, world=1,
              annotations=ann, training=False, emit='u8')
    _assert_same(_batches(DataIterator, img_dir, ann, 0, 3, **kw),
                 _batches(JaxIterator, img_dir, ann, 0, 3, **kw))


@pytest.mark.parametrize('feed', ['u8', 'f32'])
@pytest.mark.parametrize('augment', ['jitter_flip_colour', 'rotate_crop'])
def test_train_batches_equal(dataset, decode_route, feed, augment):
    """Training batches with resize jitter, flips and colour jitter (or
    90-degree rotations and IoU crops): images, padded targets, colour
    affines and sizes equal for the same seeds."""
    img_dir, ann = dataset
    kw = dict(resize=[80, 112], max_size=128, batch_size=2, stride=32,
              world=1, annotations=ann, training=True, max_det=4, seed=7,
              augment_brightness=0.1, augment_contrast=0.1,
              augment_hue=0.05, augment_saturation=0.1, emit=feed)
    if augment == 'rotate_crop':
        kw.update(rotate_augment=True, crop_augment=True)
    _assert_same(_batches(DataIterator, img_dir, ann, 3, 3, **kw),
                 _batches(JaxIterator, img_dir, ann, 3, 3, **kw))


def test_targets_padded_and_cut_at_max_det(dataset, decode_route):
    """Targets are [B, max_det, 5], -1-padded, and cut to max_det rows,
    as in the original (both loaders on one decode route)."""
    img_dir, ann = dataset
    kw = dict(resize=96, max_size=128, batch_size=5, stride=32, world=1,
              annotations=ann, training=True, emit='u8', shuffle=False)
    counts = [len(CocoIndex(ann).load_anns(i)) for i in range(5)]
    assert max(counts) > 1 and min(counts) < 3
    for max_det in (1, 3):
        got = _batches(DataIterator, img_dir, ann, 0, 1, max_det=max_det,
                       **kw)
        want = _batches(JaxIterator, img_dir, ann, 0, 1, max_det=max_det,
                        **kw)
        _assert_same(got, want)
        targets = got[0][1]
        assert targets.shape == (5, max_det, 5)
        for row, n in zip(targets, counts):
            keep = min(n, max_det)
            assert (row[:keep, 4] >= 0).all() and (row[keep:] == -1).all()


def test_feed_names_checked(dataset):
    """u8, yuv420 and f32 are the feeds; another name raises."""
    img_dir, ann = dataset
    for emit in ('u8', 'yuv420', 'f32'):
        assert DataIterator(img_dir, 96, 128, 2, 32, 1, ann, training=True,
                            emit=emit).emit == emit
    with pytest.raises(ValueError, match="unknown feed 'yuv444'"):
        DataIterator(img_dir, 96, 128, 2, 32, 1, ann, training=True,
                     emit='yuv444')


def test_evaluator_equal_on_synthetic_detections(dataset):
    """The 12 COCO stats of the copy equal the original's on jittered
    copies of the ground truth, false positives and missed objects."""
    _, ann = dataset
    rng = np.random.RandomState(0)
    with open(ann) as f:
        gt = json.load(f)
    dets = []
    for a in gt['annotations']:
        if rng.rand() < 0.2:
            continue                                # a miss
        x, y, w, h = a['bbox']
        jit = rng.randn(4) * 3
        dets.append({'image_id': a['image_id'],
                     'category_id': a['category_id'],
                     'bbox': [x + jit[0], y + jit[1], w + jit[2],
                              h + jit[3]],
                     'score': float(rng.rand())})
        dets.append({'image_id': a['image_id'],
                     'category_id': int(rng.randint(1, 4)),
                     'bbox': [float(v) for v in rng.rand(4) * 60 + 5],
                     'score': float(rng.rand() * 0.5)})
    got = CocoEvaluator(CocoIndex(ann), iou_type='bbox').evaluate(
        dets, verbose=False)
    from odtk_tpu.data import CocoIndex as JaxIndex
    want = JaxEvaluator(JaxIndex(ann), iou_type='bbox').evaluate(
        dets, verbose=False)
    assert len(got) == 12
    np.testing.assert_array_equal(got, want)
    assert 0 < got[0] < 1


def test_native_build_is_locked(tmp_path, monkeypatch):
    """Three concurrent first uses build the decoder once, into the
    hash-named library, and leave no work directory behind."""
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path))
    out = []
    threads = [threading.Thread(target=lambda: out.append(native._build()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert len(out) == 3 and len(set(out)) == 1
    assert out[0] == native.library_path()
    assert os.path.dirname(out[0]) == str(tmp_path)
    assert os.path.isfile(out[0])
    assert sorted(os.listdir(tmp_path)) == sorted(
        ['lock', os.path.basename(out[0])])
