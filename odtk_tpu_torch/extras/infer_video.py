#!/usr/bin/env python3
"""Multi-stream batched video inference, the DeepStream-pipeline
equivalent (``extras/infer_video.py`` of the JAX package; the original's
``extras/deepstream`` 1-video and 8-video configs).

Decodes N video streams with OpenCV, batches one frame per stream into
one inference call (streams ride the batch axis, as in DeepStream's
batched nvinfer), draws the detections and writes one output video per
stream.

    python -m odtk_tpu_torch.extras.infer_video model.pth|.engine out_dir \\
        in1.mp4 [in2.mp4 ...] [--size 640] [--threshold 0.3] [--device cuda]

A checkpoint runs ``Model.inference_fn_u8`` in bf16 on the u8 feed (the
normalization on the device, the weights uploaded once); an engine
(``.engine`` / ``.plan``) runs at its exported size on its f32 contract.
A ``.cppengine`` is for the C++ samples (``extras/cppapi``) and is
refused. The frame loop (``run_streams``) needs no OpenCV: ``main``
gives it OpenCV's reader, resize and writer.
"""

import argparse
import os

import numpy as np

from ..data.coco import IMAGENET_MEAN, IMAGENET_STD


def resize_bilinear(frame, size):
    """``frame`` [h, w, 3] uint8 resized to ``size`` (w, h) by bilinear
    interpolation, half-pixel centres; the resize ``run_streams`` uses
    when it is given none."""
    import torch
    import torch.nn.functional as F

    w, h = size
    if (h, w) == frame.shape[:2]:
        return frame
    x = torch.tensor(frame).permute(2, 0, 1)
    y = F.interpolate(x[None].float(), size=(h, w), mode='bilinear',
                      align_corners=False)[0]
    return y.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0).numpy()


def run_streams(dispatch, frame_sources, canvas, u8_feed=True, resize=None,
                on_batch=None):
    """The frame loop: one frame of each stream per batch, letterboxed
    into ``canvas`` (h, w) at each frame's aspect-preserving ratio, then
    ``dispatch(batch, sizes)``: batch [N, h, w, 3] uint8 RGB (``u8_feed``)
    or normalized f32, sizes [N, 2] the resized (h, w). ``dispatch`` may
    return device tensors: their fetch waits until the next batch is
    decoded and letterboxed, so decoding overlaps the computation. Then
    ``on_batch(frames, ratios, batch, sizes, (scores, boxes, classes))``
    with numpy outputs, ``frames`` each stream's RGB frame (None where
    the stream has ended). ``frame_sources``: iterables of RGB uint8
    [h, w, 3] frames, one per stream; ``resize(frame, (w, h))``:
    ``resize_bilinear`` by default. Ends when every stream has; returns
    the number of batches."""
    resize = resize or resize_bilinear
    th, tw = canvas
    n = len(frame_sources)
    iters = [iter(s) for s in frame_sources]

    def read_batch():
        frames = [next(it, None) for it in iters]
        if all(f is None for f in frames):
            return None
        batch = np.zeros((n, th, tw, 3), np.uint8 if u8_feed else np.float32)
        sizes = np.zeros((n, 2), np.float32)
        ratios = [None] * n
        for i, f in enumerate(frames):
            if f is None:
                continue
            r = ratios[i] = min(tw / f.shape[1], th / f.shape[0])
            rgb = resize(f, (int(f.shape[1] * r), int(f.shape[0] * r)))
            if not u8_feed:
                rgb = ((rgb.astype(np.float32) / 255.0 - IMAGENET_MEAN)
                       / IMAGENET_STD)
            batch[i, :rgb.shape[0], :rgb.shape[1]] = rgb
            sizes[i] = rgb.shape[:2]
        return frames, ratios, batch, sizes

    def finish(item, out):
        out = tuple(np.asarray(o.cpu()) if hasattr(o, 'cpu')
                    else np.asarray(o) for o in out)         # the fetch
        if on_batch is not None:
            on_batch(*item, out)

    # software pipeline: decode and letterbox batch k + 1 while batch k
    # computes on the device (dispatch is asynchronous; the fetch is in
    # finish)
    batches, pending = 0, None
    while True:
        item = read_batch()
        if pending is not None:
            finish(*pending)
            batches += 1
        if item is None:
            return batches
        pending = (item, dispatch(item[2], item[3]))


def checkpoint_dispatch(model, size):
    """(dispatch, canvas) of a loaded ``Model``: ``inference_fn_u8`` on
    the u8 feed and a ``size`` square canvas, on the model's device (its
    weights uploaded once, by ``Model.load``)."""
    import torch

    def dispatch(batch, sizes):
        return model.inference_fn_u8(torch.from_numpy(batch),
                                     torch.from_numpy(sizes))
    return dispatch, (size, size)


def engine_dispatch(engine):
    """(dispatch, canvas) of a loaded ``.engine`` / ``.plan``: the engine
    on its f32 contract, at its exported size."""
    def dispatch(batch, sizes):
        return engine(batch)
    return dispatch, engine.input_size


def main(args=None):
    p = argparse.ArgumentParser(description='Multi-stream batched video '
                                'inference (one frame of each stream a '
                                'batch).')
    p.add_argument('model', help='checkpoint (.pth, .ckpt) or engine '
                                 '(.engine, .plan)')
    p.add_argument('out_dir')
    p.add_argument('videos', nargs='+')
    p.add_argument('--size', type=int, default=640,
                   help='square canvas of the checkpoint route')
    p.add_argument('--threshold', type=float, default=0.3)
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; cpu runs the plain '
                        'versions of the kernels)')
    args = p.parse_args(args)

    if args.model.endswith('.cppengine'):
        raise SystemExit(
            f'{args.model}: a .cppengine is an AOTInductor package for the '
            'C++ samples (odtk_tpu_torch/extras/cppapi: odtk_infervideo); '
            'give a checkpoint or a .engine')
    import cv2
    import torch

    if args.model.endswith(('.engine', '.plan')):
        from ..export import Engine
        dispatch, canvas = engine_dispatch(Engine.load(args.model,
                                                       args.device))
        u8_feed = False      # engines keep their exported f32 contract
    else:
        from ..model import Model
        model, _ = Model.load(args.model, device=args.device)
        model.set_dtype(torch.bfloat16)
        dispatch, canvas = checkpoint_dispatch(model, args.size)
        u8_feed = True

    caps = [cv2.VideoCapture(v) for v in args.videos]
    os.makedirs(args.out_dir, exist_ok=True)
    sinks = []
    for cap, v in zip(caps, args.videos):
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 25
        sinks.append(cv2.VideoWriter(
            os.path.join(args.out_dir, os.path.basename(v)),
            cv2.VideoWriter_fourcc(*'mp4v'), fps, (w, h)))

    def frames(cap):
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def draw(frames_rgb, ratios, batch, sizes, out):
        scores, boxes, classes = out
        for i, f in enumerate(frames_rgb):
            if f is None:
                continue
            f = cv2.cvtColor(f, cv2.COLOR_RGB2BGR)
            for s, b, c in zip(scores[i], boxes[i], classes[i]):
                if s < args.threshold:
                    continue
                x1, y1, x2, y2 = (b[:4] / ratios[i]).astype(int)
                cv2.rectangle(f, (x1, y1), (x2, y2), (0, 255, 0), 2)
                cv2.putText(f, f'{int(c)}:{s:.2f}', (x1 + 2, y1 + 14),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 255, 0), 1)
            sinks[i].write(f)

    batches = run_streams(dispatch, [frames(c) for c in caps], canvas,
                          u8_feed, resize=lambda f, wh: cv2.resize(f, wh),
                          on_batch=draw)
    for cap in caps:
        cap.release()
    for sink in sinks:
        sink.release()
    print(f'processed {batches} frames x {len(caps)} streams -> '
          f'{args.out_dir}')
    return batches


if __name__ == '__main__':
    main()
