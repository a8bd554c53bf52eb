"""Prefetching data iterator with bucketed static shapes.

A copy of ``odtk_tpu/data/loader.py`` (``DataIterator`` and the
rotated-box ``RotatedDataIterator``, the ``u8``, ``yuv420`` and ``f32``
feeds): the port imports nothing of ``odtk_tpu``, and
``tests/test_torch_data.py``, ``tests/test_torch_rotated.py`` and
``tests/test_torch_yuv420.py`` hold the two equal. Host threads decode
and augment JPEGs while the device computes; batches are padded to
multiples of the model stride. Sharding follows DistributedSampler
semantics: a per-epoch permutation is split contiguously across
``world`` processes.
"""

import os
import queue
import random
import threading

import numpy as np

from .coco import (CocoDataset, RotatedCocoDataset, fit_resize_caps,
                   resize_dims, round_up)

# JFIF/BT.601 full-range RGB<->YCbCr. _YUV_A/_YUV_B are the exact
# inverse of the forward matrix so the device-side assembly
# (ops/color.apply_color_affine_yuv) reverses the host conversion to
# float precision: rgb_row = yuv_row @ _YUV_A + _YUV_B.
_RGB2YUV = np.asarray([[0.299, -0.168736, 0.5],
                       [0.587, -0.331264, -0.418688],
                       [0.114, 0.5, -0.081312]], np.float64)
_YUV_OFF = np.asarray([0.0, 128.0, 128.0], np.float64)
_YUV_A = np.linalg.inv(_RGB2YUV)
_YUV_B = -_YUV_OFF @ _YUV_A


def rgb_to_yuv420(arr_u8):
    """RGB u8 [h,w,3] -> (y u8 [h,w], cbcr u8 [ceil(h/2),ceil(w/2),2]).

    The emission format of the 'yuv420' feed: a full-resolution luma
    plane and chroma averaged over each 2x2 block (edge blocks: the mean
    of the valid pixels), 1.5 B/px, the subsampling a 4:2:0 JPEG already
    has. The native converter (``native/host_decode.cpp``
    ``odtk_rgb_to_yuv420``) when it is built, else the numpy twin
    (within 1 LSB of each other)."""
    from . import native
    out = native.rgb_to_yuv420(arr_u8)
    if out is not None:
        return out
    return _rgb_to_yuv420_numpy(arr_u8)


def _rgb_to_yuv420_numpy(arr_u8):
    """Portable numpy twin of the native converter."""
    h, w = arr_u8.shape[:2]
    yuv = arr_u8.reshape(-1, 3).astype(np.float32) @ \
        _RGB2YUV.astype(np.float32)
    yuv = yuv.reshape(h, w, 3)
    y = np.clip(yuv[:, :, 0] + 0.5, 0, 255).astype(np.uint8)
    c = yuv[:, :, 1:]
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    if (ph, pw) != (h, w):
        # edge-replicate so edge blocks average valid pixels only
        c = np.pad(c, ((0, ph - h), (0, pw - w), (0, 0)), mode='edge')
    c = c.reshape(ph // 2, 2, pw // 2, 2, 2).mean(axis=(1, 3))
    c = np.clip(c + (128.0 + 0.5), 0, 255).astype(np.uint8)
    return y, c


def fold_yuv_affine(colors_rgb):
    """Fold the YCbCr->RGB conversion into per-image color affines:
    [B,3,4] RGB-space (t, off) -> [B,3,4] YUV-space, so the device
    applies ONE affine to assembled YUV pixels."""
    a = _YUV_A.astype(np.float32)
    b = _YUV_B.astype(np.float32)
    out = np.empty_like(colors_rgb)
    out[:, :, :3] = a[None] @ colors_rgb[:, :, :3]
    out[:, :, 3] = b @ colors_rgb[:, :, :3] + colors_rgb[:, :, 3]
    return out


def _pad_batch(images, stride, fixed_size=None, dtype=np.float32):
    """Stack ragged [H,W,3] images padded to a bucketed static shape."""
    hs = [im.shape[0] for im in images]
    ws = [im.shape[1] for im in images]
    if fixed_size is not None:
        th, tw = fixed_size
    else:
        th, tw = round_up(max(hs), stride), round_up(max(ws), stride)
    out = np.zeros((len(images), th, tw, 3), dtype)
    for i, im in enumerate(images):
        out[i, :im.shape[0], :im.shape[1]] = im
    return out


def _pad_targets(targets, width, max_det):
    out = np.full((len(targets), max_det, width), -1.0, np.float32)
    for i, t in enumerate(targets):
        n = min(len(t), max_det)
        out[i, :n] = t[:n]
    return out


class DataIterator:
    """Iterates (images, targets) for training or (images, ids, ratios)
    for inference, as device-ready numpy batches."""

    dataset_cls = CocoDataset

    def __init__(self, path, resize, max_size, batch_size, stride, world,
                 annotations, training=False, rotate_augment=False,
                 crop_augment=False,
                 augment_brightness=0.0, augment_contrast=0.0,
                 augment_hue=0.0, augment_saturation=0.0, max_det=128,
                 rank=0, shuffle=None, fixed_size=None, num_threads=2,
                 prefetch=2, seed=0, absolute_angle=False, emit='f32'):
        # emit='u8' (training): batches are
        # (images u8 [B,H,W,3], targets, colors f32 [B,3,4], sizes
        # f32 [B,2]) — colors[:, :, :3] is each image's folded
        # jitter+normalize matrix, colors[:, :, 3] its offset, sizes the
        # valid (h, w) extents for on-device pad masking. 4x fewer
        # host->device bytes than the f32 feed.
        # emit='yuv420': (y u8 [B,H,W], cbcr u8 [B,H/2,W/2,2], targets,
        # colors, sizes) — 8x fewer bytes; the YCbCr->RGB conversion is
        # folded into each image's color affine (fold_yuv_affine) and
        # chroma upsamples on the device. The canvas stride keeps H, W
        # even.
        # Eval: 'u8' ships exact pixels (batches are (images u8, ids,
        # ratios, sizes); infer.py normalizes on the device); 'yuv420'
        # also subsamples chroma like the source JPEGs (batches are
        # (y, cbcr, ids, ratios, sizes)).
        if emit not in ('u8', 'yuv420', 'f32'):
            raise ValueError(f'unknown feed {emit!r}: the feeds are u8, '
                             'yuv420 and f32')
        self.emit = emit
        self.dataset = self.dataset_cls(
            path, resize=resize, max_size=max_size, stride=stride,
            annotations=annotations, training=training,
            rotate_augment=rotate_augment, crop_augment=crop_augment,
            augment_brightness=augment_brightness,
            augment_contrast=augment_contrast, augment_hue=augment_hue,
            augment_saturation=augment_saturation,
            absolute_angle=absolute_angle, fixed_size=fixed_size,
            emit='u8' if self.emit == 'yuv420' else self.emit)
        self.resize = resize
        self.max_size = max_size
        self.stride = stride
        self.world = max(1, world)
        self.rank = rank
        self.batch_size = batch_size // self.world
        if self.batch_size < 1:
            raise ValueError('batch size must be >= world size')
        self.training = training
        self.max_det = max_det
        self.fixed_size = fixed_size
        self.shuffle = training if shuffle is None else shuffle
        # cap at 2x the AVAILABLE cores (cgroup/affinity-aware): decode
        # releases the GIL and file reads block, so modest
        # oversubscription still overlaps I/O, but far-oversubscribed
        # threads only add GIL/queue contention
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:      # non-Linux
            cores = os.cpu_count() or 1
        self.num_threads = max(1, min(num_threads, 2 * cores))
        self.prefetch = prefetch
        self.epoch = 0
        self.seed = seed
        self.ids = self.dataset.ids
        self.coco = self.dataset.coco
        self._warned_images = set()   # warn once per unreadable file

    def __repr__(self):
        return '\n'.join([
            '    loader: odtk_tpu_torch (threaded, bucketed shapes)',
            '    resize: {}, max: {}, feed: {}'.format(
                self.resize, self.max_size, self.emit)])

    def _shard_indices(self):
        n = len(self.dataset)
        order = list(range(n))
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(order)
        # pad to a multiple of world like DistributedSampler
        per = -(-n // self.world)
        order = (order * 2)[:per * self.world]
        return order[self.rank * per:(self.rank + 1) * per]

    def __len__(self):
        per = -(-len(self.dataset) // self.world)
        return -(-per // self.batch_size)

    def __iter__(self):
        indices = self._shard_indices()
        self.epoch += 1
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        # Every batch must have exactly batch_size rows: the jitted step
        # and the mesh sharding are compiled for one static batch shape,
        # and shard_batch requires dim 0 divisible by the mesh size. Pad
        # a short final batch by wrapping around the epoch order —
        # training tolerates repeated samples (DistributedSampler does
        # the same) and inference dedups by image id downstream.
        if batches and len(batches[-1]) < self.batch_size:
            need = self.batch_size - len(batches[-1])
            batches[-1] = batches[-1] + [
                indices[j % len(indices)] for j in range(need)]

        work_q = queue.Queue()
        out_q = queue.Queue(maxsize=max(1, self.prefetch))
        for bi, b in enumerate(batches):
            work_q.put((bi, b))

        def worker():
            while True:
                try:
                    bi, batch_ids = work_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    out_q.put((bi, self._make_batch(batch_ids)))
                except Exception as e:  # noqa: BLE001 — must reach main
                    # a silently-dead worker would leave the consumer
                    # blocked on out_q.get() forever; ship the error
                    out_q.put((bi, e))
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()

        emitted = 0
        pending = {}
        try:
            while emitted < len(batches):
                if emitted in pending:
                    item = pending.pop(emitted)
                    if isinstance(item, Exception):
                        raise item
                    yield item
                    emitted += 1
                    continue
                bi, item = out_q.get()
                pending[bi] = item
        finally:
            # an epoch left early stops its workers before the consumer
            # goes on: none is left making batches, and drawing from the
            # global random, behind the caller's back
            while True:
                try:
                    work_q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                while t.is_alive():
                    try:
                        out_q.get(timeout=0.05)
                    except queue.Empty:
                        pass

    def _make_batch(self, batch_ids):
        if not self.training:
            fast = self._collate_eval_native(batch_ids)
            if fast is None:
                fast = self._collate(
                    [self._load_sample_safe(i) for i in batch_ids])
            if self.emit == 'yuv420':
                # eval yuv420: convert the u8 canvas rows to planes
                data, ids, ratios, sizes = fast
                yc = np.empty(data.shape[:3], np.uint8)
                cc = np.empty((data.shape[0], data.shape[1] // 2,
                               data.shape[2] // 2, 2), np.uint8)
                for i, im in enumerate(data):
                    yc[i], cc[i] = rgb_to_yuv420(im)
                return yc, cc, ids, ratios, sizes
            return fast
        samples = [self._load_sample_safe(i) for i in batch_ids]
        return self._collate(samples)

    def _load_sample_safe(self, index, max_tries=8):
        """Load dataset[index], skipping unreadable images with a
        warning instead of killing the epoch (a corrupt/truncated JPEG
        mid-epoch must not surface as a dead worker thread — the
        failure class DALI's decoder owns in the reference,
        odtk/dali.py:33-36). The sample is replaced by the next
        readable image so the batch keeps its static shape; inference
        dedups by image id downstream, training tolerates the
        substitution like any resampled example."""
        import sys
        last = None
        for k in range(max_tries):
            i = (index + k) % len(self.dataset)
            try:
                return self.dataset[i]
            except Exception as e:  # noqa: BLE001 — warned + bounded below
                last = e
                name = ''
                try:
                    name = self.dataset.coco.imgs[self.dataset.ids[i]].get(
                        'file_name', '')
                except Exception:  # noqa: BLE001 — best-effort label
                    pass
                if name not in self._warned_images:
                    self._warned_images.add(name)
                    print(f'WARNING: skipping unreadable image {name!r} '
                          f'({type(e).__name__}: {str(e)[:120]})',
                          file=sys.stderr, flush=True)
        raise RuntimeError(
            f'{max_tries} consecutive images failed to load starting at '
            f'index {index}') from last

    def _collate_eval_native(self, batch_ids):
        """Zero-copy eval batching: JPEGs decode straight into rows of
        the batch canvas (native resize+normalize writes at the canvas
        pitch and zeroes the margins itself), skipping the per-image
        buffer and the _pad_batch copy. Returns None when any image
        can't take the fast path; the caller falls back to the
        per-sample route."""
        from . import native
        if not native.available():
            return None
        ds = self.dataset
        if not isinstance(ds.resize, (int, float)):
            return None     # jittered resize draws per sample
        metas = []
        for i in batch_ids:
            img_id = ds.ids[i]
            name = ds.coco.imgs[img_id]['file_name']
            if not name.lower().endswith(('.jpg', '.jpeg')):
                return None
            full = os.path.join(ds.path, name)
            try:
                from PIL import Image
                with Image.open(full) as probe:
                    w0, h0 = probe.size
            except Exception:  # noqa: BLE001 — unreadable -> slow path
                return None
            # letterbox clamp: on a fixed (non-square) engine canvas the
            # resize is capped per image so it always fits (the slow
            # path applies the same caps in _load_resized)
            rsz, msz = fit_resize_caps(w0, h0, ds.resize, ds.max_size,
                                       self.fixed_size)
            th, tw, _ = resize_dims(w0, h0, rsz, msz)
            metas.append((img_id, full, th, tw, rsz, msz))

        if self.fixed_size is not None:
            canvas_h, canvas_w = self.fixed_size
        else:
            canvas_h = round_up(max(m[2] for m in metas), self.stride)
            canvas_w = round_up(max(m[3] for m in metas), self.stride)
        u8 = self.emit in ('u8', 'yuv420')
        canvas = np.empty((len(metas), canvas_h, canvas_w, 3),
                          np.uint8 if u8 else np.float32)
        ratios = np.empty(len(metas), np.float32)
        sizes = np.empty((len(metas), 2), np.float32)
        for i, (row, (_, full, th, tw, rsz, msz)) in enumerate(
                zip(canvas, metas)):
            with open(full, 'rb') as f:
                data = f.read()
            if u8:
                dec = native.decode_jpeg_u8(data, rsz, msz, out=row)
            else:
                dec = native.decode_jpeg(data, rsz, msz,
                                         normalize=True, out=row)
            if dec is None:
                return None
            ratios[i] = dec[3]   # the decoder's ratio, same as slow path
            sizes[i] = dec[1], dec[2]
        ids = np.asarray([m[0] for m in metas], np.int64)
        if u8:
            return canvas, ids, ratios, sizes
        return canvas, ids, ratios

    def _collate(self, samples):
        if self.training:
            images = [s[0] for s in samples]
            targets = [s[1] for s in samples]
            if self.emit in ('u8', 'yuv420'):
                colors = np.empty((len(samples), 3, 4), np.float32)
                sizes = np.empty((len(samples), 2), np.float32)
                for i, s in enumerate(samples):
                    colors[i, :, :3] = s[2]
                    colors[i, :, 3] = s[3]
                    sizes[i] = s[0].shape[:2]
                tgts = _pad_targets(targets, self.dataset.box_width,
                                    self.max_det)
                if self.emit == 'u8':
                    data = _pad_batch(images, self.stride, self.fixed_size,
                                      dtype=np.uint8)
                    return data, tgts, colors, sizes
                # yuv420: convert each augmented RGB image once, then
                # place the planes on even-dim canvases
                if self.fixed_size is not None:
                    th, tw = self.fixed_size
                    if th % 2 or tw % 2:
                        raise ValueError(
                            f'yuv420 feed needs an even canvas, got '
                            f'fixed_size={self.fixed_size}; use the u8 '
                            f'feed or an even size')
                else:
                    th = round_up(max(im.shape[0] for im in images),
                                  self.stride)
                    tw = round_up(max(im.shape[1] for im in images),
                                  self.stride)
                yc = np.zeros((len(images), th, tw), np.uint8)
                cc = np.zeros((len(images), th // 2, tw // 2, 2), np.uint8)
                for i, im in enumerate(images):
                    y, c = rgb_to_yuv420(np.ascontiguousarray(im))
                    yc[i, :y.shape[0], :y.shape[1]] = y
                    cc[i, :c.shape[0], :c.shape[1]] = c
                return yc, cc, tgts, fold_yuv_affine(colors), sizes
            data = _pad_batch(images, self.stride, self.fixed_size)
            return data, _pad_targets(targets, self.dataset.box_width,
                                      self.max_det)
        images = [s[0] for s in samples]
        ids = np.asarray([s[1] for s in samples], np.int64)
        ratios = np.asarray([s[2] for s in samples], np.float32)
        if self.emit in ('u8', 'yuv420'):
            data = _pad_batch(images, self.stride, self.fixed_size,
                              dtype=np.uint8)
            sizes = np.asarray([im.shape[:2] for im in images], np.float32)
            return data, ids, ratios, sizes
        data = _pad_batch(images, self.stride, self.fixed_size)
        return data, ids, ratios


class RotatedDataIterator(DataIterator):
    dataset_cls = RotatedCocoDataset
