"""Inference / evaluation workflow.

Counterpart of ``odtk_tpu/infer.py``, on a checkpoint model or an
exported ``Engine`` (``export.py``), on one device or, in a process
group (``parallel``), on one device a process: each rank runs its shard
of the images, the results are gathered after the last batch
(``parallel.all_gather_host``) and rank 0 alone de-duplicates them by
image id, writes the JSON and evaluates; the other ranks return no
stats. Batches come from the port's copy of the ``DataIterator``: for a
model on the eval feed that ``ODTK_EVAL_FEED`` names (``u8`` by
default, ``yuv420`` or ``f32``; another value gives ``u8``), for an
engine on the f32 feed (normalized on the host) at the engine's fixed
input size, the contract its programs were exported with
(``odtk_tpu/infer.py:36-62``). Each batch's arrays go to the device
from pinned host memory with a non-blocking copy, the whole
normalize -> backbone -> heads -> decode -> NMS path runs there, and the
results stay on the device until the gather after the last batch, so the
host never waits for the device inside the loop. The detection JSON has
the JAX package's schema and ``CocoEvaluator`` scores it: 'bbox' for an
axis-aligned model; for a rotated one ('segm') each detection's
``bbox`` is [x, y, w, h, theta] with theta = atan2(sin, cos) and its
``segmentation`` the rotated corner polygon.

Batch times are read from CUDA events recorded after each batch on the
device's own clock (host clock on the CPU): the interval between two
batches' events is the time the pipeline spends per batch, loader
included, without a synchronization inside the loop.
"""

import json
import os
import statistics
import time

import numpy as np
import torch

from . import parallel
from .data import CocoEvaluator, DataIterator, RotatedDataIterator
from .utils import rotate_box


class BatchClock:
    """Marks the end of each batch's queued work; ``intervals_ms`` after
    the gather gives the time between consecutive marks."""

    def __init__(self, device):
        self.cuda = device.type == 'cuda'
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                       self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def infer(model, path, detections_file, resize, max_size, batch_size,
          mixed_precision=True, annotations=None, verbose=True,
          fixed_size=None, device='cuda', rotated_bbox=False):
    """Run inference on the images in ``path``, in a process group on
    this rank's shard with ``batch_size`` the global batch. Returns a
    dict: ``stats``, the COCO stats when ``annotations`` are given and
    there are detections (rank 0 only), else None; ``batch_ms``, the
    intervals between consecutive batches (see ``BatchClock``)."""
    engine = hasattr(model, 'input_size')
    device = model.device if engine else torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but no CUDA device is '
                           'available (pass --device cpu to run on the CPU)')
    if engine:
        # engines are exported for a fixed input size
        fixed_size = model.input_size
    if fixed_size is not None:
        max_size = max(fixed_size)
    rank, world = parallel.world_info()
    # the clean startup error of a batch that does not divide
    parallel.host_local_batch_size(batch_size, world, 1)

    if verbose:
        print('Preparing dataset...')
    iterator_cls = RotatedDataIterator if rotated_bbox else DataIterator
    eval_feed = 'f32'
    if not engine:
        eval_feed = os.environ.get('ODTK_EVAL_FEED', 'u8')
        if eval_feed not in ('f32', 'u8', 'yuv420'):
            eval_feed = 'u8'
    data_iterator = iterator_cls(
        path, resize, max_size, batch_size, model.stride, world, annotations,
        training=False, rank=rank, fixed_size=fixed_size, emit=eval_feed)
    if verbose:
        print(data_iterator)

    if engine:
        precision = model.meta['precision']
    elif mixed_precision:
        model.to(device).set_dtype(torch.bfloat16)
        precision = 'mixed (bf16)'
    else:
        model.to(device).set_dtype(torch.float32)
        precision = 'full (fp32)'
    if precision in ('full (fp32)', 'fp32', 'FP32'):
        # full precision means fp32 arithmetic: cuDNN convolutions and
        # matmuls would otherwise run in TF32 on the card
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    if verbose:
        name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
                else 'CPU')
        print('   backend: torch {}{}'.format(
            torch.__version__, ', engine' if engine else ''))
        print('    device: {}'.format(name))
        print('     batch: {}, precision: {}'.format(batch_size, precision))
        print(' BBOX type:', 'rotated' if rotated_bbox else 'axis aligned')
        print('Running inference...')

    pin = device.type == 'cuda'

    def to_device(array):
        tensor = torch.from_numpy(array)
        if pin:
            tensor = tensor.pin_memory()
        return tensor.to(device, non_blocking=True)

    results = []
    clock = BatchClock(device)
    for batch in data_iterator:
        if eval_feed == 'yuv420':
            y, cbcr, ids, ratios, sizes = batch
            scores, boxes, classes = model.inference_fn_yuv(
                to_device(y), to_device(cbcr), to_device(sizes))
        elif eval_feed == 'u8':
            data, ids, ratios, sizes = batch
            scores, boxes, classes = model.inference_fn_u8(
                to_device(data), to_device(sizes))
        else:
            data, ids, ratios = batch
            images = to_device(data)
            scores, boxes, classes = (model(images) if engine
                                      else model.inference_fn(images))
        results.append([scores, boxes, classes, ids, ratios])
        clock.mark()

    batch_ms = clock.intervals_ms()
    if verbose:
        size = len(data_iterator.ids)
        print('[{}/{}] {} batches of {}'.format(
            size, size, len(batch_ms), batch_size))
        if len(batch_ms) > 1:
            print('    timing: {:.3f} ms/batch, median of the {} batches '
                  'after the first ({} clock)'.format(
                      statistics.median(batch_ms[1:]), len(batch_ms) - 1,
                      'device' if device.type == 'cuda' else 'host'))
        print('Gathering results...')
    scores, boxes, classes, ids, ratios = zip(*results)
    results = [torch.cat(scores), torch.cat(boxes), torch.cat(classes),
               np.concatenate(ids), np.concatenate(ratios)]
    gathered = [parallel.all_gather_host(r) for r in results]
    if world > 1:
        gathered = [g.reshape(-1, *g.shape[2:]) for g in gathered]
    if rank != 0:
        return {'stats': None, 'batch_ms': batch_ms}

    detections = []
    processed_ids = set()
    cat_ids = data_iterator.coco.get_cat_ids()
    for scores, boxes, classes, image_id, ratio in zip(*gathered):
        image_id = int(image_id)
        if image_id in processed_ids:
            continue
        processed_ids.add(image_id)
        keep = scores > 0
        boxes_k = boxes[keep].copy()
        boxes_k[:, :4] /= ratio
        for score, box, cat in zip(scores[keep], boxes_k,
                                   classes[keep].astype(np.int64)):
            x1, y1, x2, y2, *sincos = box.tolist()
            cat = int(cat)
            if cat_ids:
                cat = cat_ids[cat]
            det = {'image_id': image_id, 'score': float(score),
                   'category_id': cat,
                   'bbox': [x1, y1, x2 - x1 + 1, y2 - y1 + 1]}
            if rotated_bbox:
                theta = float(np.arctan2(*sincos))
                det['bbox'].append(theta)
                det['segmentation'] = [rotate_box(det['bbox'])]
            detections.append(det)

    if not detections:
        print('No detections!')
        return {'stats': None, 'batch_ms': batch_ms}

    out = {'annotations': detections,
           'images': data_iterator.coco.dataset.get('images', [])}
    if 'categories' in data_iterator.coco.dataset:
        out['categories'] = data_iterator.coco.dataset['categories']
    if detections_file:
        if isinstance(detections_file, str):
            detections_file = [detections_file]
        for d_file in detections_file:
            if verbose:
                print('Writing {}...'.format(d_file))
            with open(d_file, 'w') as f:
                json.dump(out, f, indent=4)

    if 'annotations' in data_iterator.coco.dataset:
        if verbose:
            print('Evaluating model...')
        evaluator = CocoEvaluator(data_iterator.coco,
                                  iou_type='segm' if rotated_bbox else 'bbox')
        stats = evaluator.evaluate(detections, verbose=True)
    else:
        stats = None
    return {'stats': stats, 'batch_ms': batch_ms}
