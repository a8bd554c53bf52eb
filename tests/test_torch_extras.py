"""The port's deployment extras on the CPU: ``generate_anchors`` against
the JAX package's script, ``infer_video``'s frame loop against the port's
and the JAX package's ``inference_fn_u8``, its OpenCV front end on two
mp4s, and the shell harness ``extras/test.sh`` (its syntax; the harness
itself runs on the card).

One fp32 ResNet18FPN (3 classes) from the JAX model's numpy weights
through the weight bridge, with the final head kernels spread as in
``tests/test_torch_export.py``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from odtk_tpu.model import Model as JaxModel
from odtk_tpu_torch.extras import infer_video
from test_torch_export import port_model, spread_variables
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {'threshold': 0.001}


def _script(args):
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    run = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return run.stdout


@pytest.mark.parametrize('flags', [[], ['--rotated']])
def test_generate_anchors_prints_the_jax_scripts_text(flags):
    """The port's script prints the JAX package's text, character for
    character (both print each anchor with 7 significant digits of the
    same float32 numpy arithmetic)."""
    want = _script([os.path.join(REPO, 'extras', 'generate_anchors.py'),
                    *flags])
    got = _script(['-m', 'odtk_tpu_torch.extras.generate_anchors', *flags])
    assert got == want
    assert got.count('const std::vector<float> anchors_') == 5


@pytest.fixture(scope='module')
def variables():
    return spread_variables()


def _streams(n_frames, seed, hw=(90, 120)):
    """Two streams of RGB frames, the second one frame shorter and of
    another aspect."""
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
             for _ in range(n_frames)],
            [rng.randint(0, 256, (hw[1], hw[0], 3)).astype(np.uint8)
             for _ in range(n_frames - 1)]]


def test_run_streams_equals_inference_fn_u8(variables):
    """``run_streams`` by the checkpoint route: every batch's detections
    equal the port's ``inference_fn_u8`` on the same batch, and hold the
    JAX model's ``inference_fn_u8`` on the same weights and batch to
    ``test_inference_fn_u8_matches_jax``'s tolerance (detections matched
    by class and score, scores within 1e-5, boxes within 1e-2 px, fp32).
    An ended stream leaves a zero image and size in its slot."""
    model = port_model(variables, CONFIG)
    dispatch, canvas = infer_video.checkpoint_dispatch(model, 128)
    seen = []
    batches = infer_video.run_streams(
        dispatch, _streams(3, seed=1), canvas,
        on_batch=lambda *item: seen.append(item))
    assert batches == len(seen) == 3
    jmodel = JaxModel('ResNet18FPN', classes=3, config=CONFIG)
    jax_fn = jax.jit(jmodel.inference_fn_u8)
    for frames, ratios, batch, sizes, out in seen:
        assert batch.dtype == np.uint8 and batch.shape == (2, 128, 128, 3)
        want = model.inference_fn_u8(torch.from_numpy(batch),
                                     torch.from_numpy(sizes))
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a, b.numpy())
        ref = jax_fn(variables, batch, sizes)
        for i, frame in enumerate(frames):
            if frame is None:
                assert not sizes[i].any() and not batch[i].any()
                continue
            assert ratios[i] == min(128 / frame.shape[1],
                                    128 / frame.shape[0])
            g = [o[i] for o in out]
            w = [np.asarray(r[i]) for r in ref]
            keep_g, keep_w = g[0] > 0, w[0] > 0
            assert keep_g.sum() == keep_w.sum() > 5
            og = np.lexsort((-g[0][keep_g], g[2][keep_g]))
            ow = np.lexsort((-w[0][keep_w], w[2][keep_w]))
            np.testing.assert_array_equal(g[2][keep_g][og], w[2][keep_w][ow])
            np.testing.assert_allclose(g[0][keep_g][og], w[0][keep_w][ow],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(g[1][keep_g][og], w[1][keep_w][ow],
                                       rtol=0, atol=1e-2)


def test_run_streams_engine_route_feeds_normalized_f32(variables):
    """The engine route's batches are the f32 contract: each frame
    letterboxed and normalized, the pad at 0 (normalized), as the JAX
    script's engine branch feeds an engine."""
    calls = []

    def dispatch(batch, sizes):
        calls.append((batch, sizes))
        return (np.zeros((2, 5)), np.zeros((2, 5, 4)), np.zeros((2, 5)))

    frames = _streams(2, seed=2)
    infer_video.run_streams(dispatch, frames, (128, 160), u8_feed=False)
    batch, sizes = calls[0]
    assert batch.dtype == np.float32 and batch.shape == (2, 128, 160, 3)
    np.testing.assert_array_equal(sizes, [[120, 160], [128, 96]])
    pixels = infer_video.resize_bilinear(frames[0][0], (160, 120))
    np.testing.assert_allclose(
        batch[0, :120], (pixels / np.float32(255) - infer_video.IMAGENET_MEAN)
        / infer_video.IMAGENET_STD, rtol=0, atol=1e-6)
    assert not batch[0, 120:].any() and not batch[1, :, 96:].any()
    assert len(calls) == 2


def test_infer_video_writes_every_frame(variables, tmp_path):
    """``infer_video`` on two 3-frame mp4s (checkpoint route, bf16, on the
    CPU) writes one video per stream with every frame."""
    cv2 = pytest.importorskip('cv2')
    ckpt = str(tmp_path / 'm.pth')
    port_model(variables).save({'path': ckpt})
    videos = []
    for s, (h, w) in enumerate(((96, 128), (80, 112))):
        path = str(tmp_path / f'in{s}.mp4')
        sink = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), 25,
                               (w, h))
        for frame in _streams(3, seed=3 + s, hw=(h, w))[0]:
            sink.write(frame)
        sink.release()
        videos.append(path)
    out_dir = str(tmp_path / 'out')
    batches = infer_video.main([ckpt, out_dir, *videos, '--size', '128',
                                '--device', 'cpu'])
    assert batches == 3
    for path in videos:
        cap = cv2.VideoCapture(os.path.join(out_dir, os.path.basename(path)))
        frames = 0
        while cap.read()[0]:
            frames += 1
        cap.release()
        assert frames == 3


def test_infer_video_refuses_cppengine(tmp_path):
    with pytest.raises(SystemExit, match='cppengine'):
        infer_video.main([str(tmp_path / 'm.cppengine'), str(tmp_path),
                          'in.mp4', '--device', 'cpu'])


def test_test_sh_parses():
    run = subprocess.run(['bash', '-n', os.path.join(
        REPO, 'odtk_tpu_torch', 'extras', 'test.sh')], capture_output=True,
        text=True, timeout=60)
    assert run.returncode == 0, run.stderr
