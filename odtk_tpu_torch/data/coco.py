"""COCO-JSON dataset with host-side decode and augmentation.

A copy of ``odtk_tpu/data/coco.py`` (``CocoDataset`` and the rotated-box
``RotatedCocoDataset``): the port imports nothing of ``odtk_tpu``, and
``tests/test_torch_data.py`` and ``tests/test_torch_rotated.py`` hold
the two equal. Aspect-preserving resize with a shorter-side target
(randomized within ``jitter`` for training) capped by ``max_size``,
90-degree rotation augment with box remap, horizontal flip, gaussian
colour jitter folded into one per-image affine, ImageNet normalization.
Images are padded at batch collation to multiples of the model stride.
pycocotools is not used: ``CocoIndex`` parses the COCO JSON.
"""

import json
import math
import os
import random

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class CocoIndex:
    """Minimal COCO-JSON index (the pycocotools.COCO surface we need)."""

    def __init__(self, annotations_path=None, dataset=None):
        if dataset is None:
            with open(annotations_path) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs = {im['id']: im for im in dataset.get('images', [])}
        self.anns = {}
        self.img_to_anns = {im_id: [] for im_id in self.imgs}
        for ann in dataset.get('annotations', []):
            self.anns[ann['id']] = ann
            self.img_to_anns.setdefault(ann['image_id'], []).append(ann)
        self.cats = {c['id']: c for c in dataset.get('categories', [])}

    def get_cat_ids(self):
        return sorted(self.cats)

    def get_img_ids(self):
        return list(self.imgs)

    def load_anns(self, img_id):
        return self.img_to_anns.get(img_id, [])

    @classmethod
    def from_image_dir(cls, path):
        """Bare image folder -> id-only dataset (odtk/infer.py:28-31)."""
        images = [{'id': i, 'file_name': f}
                  for i, f in enumerate(sorted(os.listdir(path)))]
        return cls(dataset={'images': images})


# fused eval normalization: raw 0..255 -> (x/255 - mean)/std
_EVAL_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_EVAL_OFFSET = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)
_GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def _normalize_eval(arr):
    """Raw 0..255 float32 [H,W,3] -> ImageNet-normalized, in place.

    Per-column strided scalar ops: numpy's [3]-broadcast forms run a
    3-element inner loop with no SIMD (~5x slower at these sizes).
    """
    flat = arr.reshape(-1, 3)
    for ch in range(3):
        col = flat[:, ch]
        col *= _EVAL_SCALE[ch]
        col += _EVAL_OFFSET[ch]
    return flat.reshape(arr.shape)
# clip bounds of the [0,1] pixel range, expressed post-normalization
_CLIP_LO = ((0.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
_CLIP_HI = ((1.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def _hue_matrix(f):
    """Right-multiplication RGB matrix rotating hue by ``f`` turns.

    Rotation happens in YIQ space, whose luma axis is the fixed point —
    neutral pixels (r=g=b) are exactly preserved, which is what lets
    the hue op fold into the single affine color transform below.
    Deliberate divergence from the reference's HSV-space rotation
    (data.py:103-109 via torchvision adjust_hue): the two differ by
    ~13.5*f in [0,1] pixel units (measured) — under one uint8
    quantization step at the default jitter strength (sigma 2e-4 of a
    turn) — and the YIQ form is one 3x3 matmul instead of two
    colorspace conversion passes per image.
    """
    th = 2.0 * math.pi * f
    u, w = math.cos(th), math.sin(th)
    m = np.asarray([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.322],
                    [0.211, -0.523, 0.312]], np.float64)
    rot = np.asarray([[1, 0, 0], [0, u, -w], [0, w, u]], np.float64)
    return (np.linalg.inv(m) @ rot @ m).T


def _color_jitter_normalize(arr, brightness, contrast, hue, saturation):
    """Fused color jitter + ImageNet normalization.

    Input: float32 [H,W,3] RGB in 0..255 (decode output). Output: the
    normalized float32 array the model consumes. Matches the reference's
    sequential chain (data.py:92-109 then normalize): brightness gain
    fb, contrast blend toward mean gray fc, saturation blend toward
    per-pixel gray fs, hue rotation, clip to [0,1], (x-mean)/std.

    Every step is affine in the pixel vector, so the whole chain folds
    into  out = clip(arr @ T + gray(arr)[...,None] * B + C)  — one 3x3
    matmul, one gray blend, one offset+clip — instead of ~12 allocating
    full-image passes plus an HSV round-trip. Derivation: with
    x0 = arr/255, g0 = gray(x0), m0 = mean(g0),
      x3 = fb*fc*fs*x0 + fb*fc*(1-fs)*g0[...,None] + fb*(1-fc)*m0
    and the YIQ hue rotation H fixes both the neutral axis (g0 term)
    and constants, so x4 = x0 @ (A*H) + B*g0[...,None] + C with
    A = fb*fc*fs, B = fb*fc*(1-fs), C = fb*(1-fc)*m0.
    """
    fb, fc, fs, fh = _draw_jitter(brightness, contrast, hue, saturation)
    flat = arr.reshape(-1, 3)
    mgray01 = 0.0
    if fc != 1.0:
        # BLAS matvec + contiguous mean; a column-wise flat.mean(0)
        # reduce is ~10x slower than this at image sizes
        mgray01 = float((flat @ _GRAY).mean()) / 255.0
    t, off = color_affine(fb, fc, fs, fh, mgray01)
    out = flat @ t
    # ... plus per-column offset/clip — strided scalar ops beat numpy's
    # last-axis [3]-broadcast forms ~5x (3-element inner loop, no SIMD)
    for ch in range(3):
        col = out[:, ch]
        col += np.float32(off[ch])
        np.clip(col, _CLIP_LO[ch], _CLIP_HI[ch], out=col)
    return out.reshape(arr.shape)


def _draw_jitter(brightness, contrast, hue, saturation):
    """Per-image jitter factor draws (reference sampling, data.py:92-109)."""
    fb = max(0.0, random.normalvariate(1, brightness)) if brightness else 1.0
    fc = max(0.0, random.normalvariate(1, contrast)) if contrast else 1.0
    fs = max(0.0, random.normalvariate(1, saturation)) if saturation else 1.0
    fh = (float(np.clip(random.normalvariate(0, hue), -0.5, 0.5))
          if hue else 0.0)
    return fb, fc, fs, fh


def color_affine(fb, fc, fs, fh, mgray01):
    """The jitter+normalize chain as one affine: 0..255 RGB -> normalized.

    Returns (t [3,3] f32, off [3] f32) with out = pixels @ t + off
    (clip to [_CLIP_LO, _CLIP_HI] per channel completes the chain).
    ``mgray01`` is the image's mean gray in [0,1] (only consulted when
    fc != 1). Shared by the host float path (_color_jitter_normalize)
    and the u8 emit mode, where the SAME (t, off) ships to the device
    and the affine runs in-graph on u8 pixels — so both paths are the
    same math by construction."""
    a = fb * fc * fs
    b = fb * fc * (1.0 - fs)
    c = fb * (1.0 - fc) * mgray01
    # gray blend g0[...,None]*b == x0 @ outer(_GRAY, b*ones): rank-1,
    # so the whole chain is ONE [N,3]@[3,3] pass
    t = _hue_matrix(fh) * a if fh else np.eye(3) * a
    t = t + np.outer(_GRAY, np.full(3, b))
    t = (t / (255.0 * IMAGENET_STD[None, :])).astype(np.float32)
    off = ((c - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    return t, off


def round_up(v, m):
    return int(math.ceil(v / m) * m)


def fit_resize_caps(w0, h0, resize, max_size, fit_hw):
    """Cap (resize, max_size) so a w0 x h0 source fits a fixed (H, W)
    canvas (letterbox clamp for non-square engines; the reference avoids
    this case by forcing resize to the engine size, odtk/infer.py:34).

    resize_dims computes r = min(resize/min_side, max_size/max_side),
    so fitting within the canvas is exactly two extra caps: the fit dim
    along the image's shorter side bounds ``resize``, the one along its
    longer side bounds ``max_size``. Works identically through the
    native decoder (which recomputes r from the same two ints).
    """
    if fit_hw is None:
        return resize, max_size
    fh, fw = fit_hw
    short_fit, long_fit = (fw, fh) if w0 <= h0 else (fh, fw)
    return min(resize, short_fit), min(max_size, long_fit)


def resize_dims(w0, h0, resize, max_size):
    """Aspect-preserving target dims (th, tw, ratio) for a w0 x h0
    source: shorter side -> ``resize`` capped so the longer side stays
    <= ``max_size`` (the reference rule, data.py:52-60).

    The arithmetic deliberately runs in float32 to match the native
    decoder bit-for-bit (host_decode.cpp computes the same ratio in C
    float): at boundary sizes a float64 version rounds int(r*side) to a
    different pixel count, and the fast/slow loader paths would resize
    on different grids. The single source of truth for every caller.
    """
    f32 = np.float32
    r = f32(resize) / f32(min(w0, h0))
    if float(r * f32(max(w0, h0))) > max_size:
        r = f32(max_size) / f32(max(w0, h0))
    th = max(1, int(r * f32(h0)))
    tw = max(1, int(r * f32(w0)))
    return th, tw, float(r)


class CocoDataset:
    """Axis-aligned detection dataset.

    __getitem__ -> (image [H,W,3] float32 normalized (padding is the
                    loader's job, at batch collation),
                    target [n,5] (x,y,w,h,class)) when training,
                   (image, id, ratio) otherwise.
    """
    box_width = 5

    def __init__(self, path, resize, max_size, stride, annotations=None,
                 training=False, rotate_augment=False, crop_augment=False,
                 augment_brightness=0.0,
                 augment_contrast=0.0, augment_hue=0.0, augment_saturation=0.0,
                 absolute_angle=False, fixed_size=None, emit='f32'):
        # emit='u8' (training only): __getitem__ returns
        # (u8 image, target, color_t [3,3], color_off [3]) — raw resized
        # pixels plus the per-image jitter+normalize affine, which the
        # train graph applies on-device (color_affine). 4x fewer bytes
        # over the host->device link and no host jitter matmul.
        self.emit = emit
        self.path = os.path.expanduser(path)
        self.resize = resize
        self.max_size = max_size
        # fixed engine canvas (H, W): resize is letterbox-clamped so
        # every image fits it (fit_resize_caps)
        self.fixed_size = fixed_size
        self.stride = stride
        self.training = training
        self.rotate_augment = rotate_augment
        self.crop_augment = crop_augment
        if crop_augment and self.box_width == 6:
            raise ValueError('crop augmentation does not support rotated '
                             'boxes (the reference DALI crop path has the '
                             'same restriction, odtk/train.py:64)')
        self.augment_brightness = augment_brightness
        self.augment_contrast = augment_contrast
        self.augment_hue = augment_hue
        self.augment_saturation = augment_saturation
        self.absolute_angle = absolute_angle

        if annotations:
            self.coco = CocoIndex(annotations)
        else:
            self.coco = CocoIndex.from_image_dir(self.path)
        self.ids = self.coco.get_img_ids()
        self.categories_inv = {k: i for i, k in
                               enumerate(self.coco.get_cat_ids())}

    def __len__(self):
        return len(self.ids)

    # ---------------------------------------------------------------- io
    def _load_image(self, img_id):
        name = self.coco.imgs[img_id]['file_name']
        return Image.open(os.path.join(self.path, name)).convert('RGB')

    def _load_resized(self, img_id, resize, normalize):
        """Decode + aspect-preserving resize -> (float32 [h,w,3], ratio).

        Fast path: native libjpeg decode+bilinear (+fused normalize),
        GIL-free (native/host_decode.cpp). Fallback: PIL decode with
        native resize when available, else PIL bilinear.
        """
        from . import native
        name = self.coco.imgs[img_id]['file_name']
        full = os.path.join(self.path, name)
        if name.lower().endswith(('.jpg', '.jpeg')) and native.available():
            with open(full, 'rb') as f:
                data = f.read()
            with Image.open(full) as probe:
                w0, h0 = probe.size
            rsz, msz = fit_resize_caps(w0, h0, resize, self.max_size,
                                       self.fixed_size)
            th, tw, _ = resize_dims(w0, h0, rsz, msz)
            out = native.decode_jpeg(data, rsz, msz,
                                     pad_to=(th, tw), normalize=normalize)
            if out is not None:
                arr, oh, ow, r = out
                return arr, r, normalize
        im = self._load_image(img_id)
        w0, h0 = im.size
        rsz, msz = fit_resize_caps(w0, h0, resize, self.max_size,
                                   self.fixed_size)
        th, tw, ratio = resize_dims(w0, h0, rsz, msz)
        if native.available():
            arr = native.resize_rgb(np.asarray(im, np.uint8), th, tw,
                                    normalize=normalize)
            if arr is not None:
                return arr, ratio, normalize
        im = im.resize((tw, th), Image.BILINEAR)
        return np.asarray(im, np.float32), ratio, False

    def _load_resized_u8(self, img_id, resize):
        """Decode + aspect-preserving resize -> (uint8 [h,w,3], ratio).

        The emit='u8' twin of _load_resized: raw pixels, no color math
        (the per-image color affine runs on-device instead)."""
        from . import native
        name = self.coco.imgs[img_id]['file_name']
        full = os.path.join(self.path, name)
        if name.lower().endswith(('.jpg', '.jpeg')) and native.available():
            with open(full, 'rb') as f:
                data = f.read()
            with Image.open(full) as probe:
                w0, h0 = probe.size
            rsz, msz = fit_resize_caps(w0, h0, resize, self.max_size,
                                       self.fixed_size)
            th, tw, _ = resize_dims(w0, h0, rsz, msz)
            out = native.decode_jpeg_u8(data, rsz, msz, pad_to=(th, tw))
            if out is not None:
                arr, oh, ow, r = out
                return arr, r
        im = self._load_image(img_id)
        w0, h0 = im.size
        rsz, msz = fit_resize_caps(w0, h0, resize, self.max_size,
                                   self.fixed_size)
        th, tw, ratio = resize_dims(w0, h0, rsz, msz)
        if native.available():
            arr = native.resize_rgb_u8(np.asarray(im, np.uint8), th, tw)
            if arr is not None:
                return arr, ratio
        im = im.resize((tw, th), Image.BILINEAR)
        return np.asarray(im, np.uint8), ratio

    def _draw_color_affine(self, arr_u8):
        """Sample this image's jitter and fold it (with normalization)
        into one (t, off) affine for on-device application."""
        fb, fc, fs, fh = _draw_jitter(
            self.augment_brightness, self.augment_contrast,
            self.augment_hue, self.augment_saturation)
        mgray01 = 0.0
        if fc != 1.0:
            # per-channel means then dot: equals mean(gray) by linearity
            m = arr_u8.mean(axis=(0, 1), dtype=np.float64)
            mgray01 = float(m @ _GRAY.astype(np.float64)) / 255.0
        return color_affine(fb, fc, fs, fh, mgray01)

    def _get_target(self, img_id):
        boxes, categories = [], []
        for ann in self.coco.load_anns(img_id):
            bbox = list(ann['bbox'])
            if bbox[2] < 1 and bbox[3] < 1:
                continue
            boxes.append(self._prep_bbox(bbox, img_id))
            cat = ann['category_id']
            if self.categories_inv:
                cat = self.categories_inv[cat]
            categories.append(cat)
        if boxes:
            return (np.asarray(boxes, np.float32),
                    np.asarray(categories, np.float32)[:, None])
        w = self.box_width - 1
        return np.ones((1, w), np.float32), -np.ones((1, 1), np.float32)

    def _prep_bbox(self, bbox, img_id):
        return bbox[:4]

    # ---------------------------------------------------------- transforms
    def _sample_resize(self):
        r = self.resize
        if isinstance(r, (list, tuple)):
            r = random.randint(int(r[0]), int(r[-1]))
        return r

    # RandomBBoxCrop parameters (dali.py:33-36): IoU floor sampled from
    # the DALI threshold set with a no-crop option, window is a uniform
    # rescale of the image in [0.3, 1].
    CROP_THRESHOLDS = (None, 0.1, 0.3, 0.5, 0.7, 0.9)
    CROP_SCALING = (0.3, 1.0)
    CROP_ATTEMPTS = 50

    def _random_crop(self, im, boxes, categories):
        """SSD-style crop in original pixel space (dali.py:71-74).

        Picks an IoU floor, samples windows until at least one gt box
        overlaps the window by >= floor AND at least one box center
        lies inside; surviving boxes are clipped to the window.
        Returns (PIL image, boxes xywh, categories), possibly unchanged.
        """
        floor = random.choice(self.CROP_THRESHOLDS)
        if floor is None or len(boxes) == 0 or categories[0, 0] < 0:
            return im, boxes, categories
        w0, h0 = im.size
        x1, y1 = boxes[:, 0], boxes[:, 1]
        x2, y2 = x1 + boxes[:, 2], y1 + boxes[:, 3]
        area = boxes[:, 2] * boxes[:, 3]
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        for _ in range(self.CROP_ATTEMPTS):
            s = random.uniform(*self.CROP_SCALING)
            cw, ch = max(1, int(s * w0)), max(1, int(s * h0))
            wx = random.randint(0, w0 - cw)
            wy = random.randint(0, h0 - ch)
            ix1 = np.maximum(x1, wx)
            iy1 = np.maximum(y1, wy)
            ix2 = np.minimum(x2, wx + cw)
            iy2 = np.minimum(y2, wy + ch)
            inter = (np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0))
            iou = inter / (area + cw * ch - inter)
            centered = ((cx >= wx) & (cx < wx + cw)
                        & (cy >= wy) & (cy < wy + ch))
            if iou.max() < floor or not centered.any():
                continue
            im = im.crop((wx, wy, wx + cw, wy + ch))
            nb = np.stack([ix1 - wx, iy1 - wy,
                           ix2 - ix1, iy2 - iy1], axis=1)
            return im, nb[centered].astype(np.float32), categories[centered]
        return im, boxes, categories

    def _load_cropped_resized(self, img_id, resize):
        """Crop-augmented decode path: full decode, crop in original
        pixel space, THEN aspect-preserving resize — the crop gets the
        full resize budget (zoom-in), matching the reference's
        decode-slice-then-resize order (dali.py:71-74)."""
        im = self._load_image(img_id)
        boxes, categories = self._get_target(img_id)
        im, boxes, categories = self._random_crop(im, boxes, categories)
        w0, h0 = im.size
        th, tw, ratio = resize_dims(w0, h0, resize, self.max_size)
        from . import native
        arr = None
        if self.emit == 'u8':
            if native.available():
                arr = native.resize_rgb_u8(np.asarray(im, np.uint8), th, tw)
            if arr is None:
                arr = np.asarray(im.resize((tw, th), Image.BILINEAR),
                                 np.uint8)
        else:
            if native.available():
                arr = native.resize_rgb(np.asarray(im, np.uint8), th, tw,
                                        normalize=False)
            if arr is None:
                arr = np.asarray(im.resize((tw, th), Image.BILINEAR),
                                 np.float32)
        if len(boxes) == 0:
            boxes = np.ones((1, self.box_width - 1), np.float32)
            categories = -np.ones((1, 1), np.float32)
        return arr, ratio, boxes, categories

    def __getitem__(self, index):
        img_id = self.ids[index]
        resize = self._sample_resize()

        target = None
        if self.training and self.crop_augment:
            arr, ratio, boxes, categories = self._load_cropped_resized(
                img_id, resize)
            boxes = self._scale_boxes(boxes, ratio)
            # absorb integer-resize rounding: keep boxes on the canvas
            h, w = arr.shape[:2]
            hi_x = np.clip(boxes[:, 0] + boxes[:, 2], 0, w)
            hi_y = np.clip(boxes[:, 1] + boxes[:, 3], 0, h)
            boxes[:, 0] = np.clip(boxes[:, 0], 0, w - 1)
            boxes[:, 1] = np.clip(boxes[:, 1], 0, h - 1)
            boxes[:, 2] = np.maximum(hi_x - boxes[:, 0], 1e-3)
            boxes[:, 3] = np.maximum(hi_y - boxes[:, 1], 1e-3)
            if self.emit == 'u8':
                t, off = self._draw_color_affine(arr)
                arr, boxes = self._geometric_augment(arr, boxes)
                target = np.concatenate([boxes, categories], axis=1)
                return arr, target, t, off
            arr = _color_jitter_normalize(
                arr, self.augment_brightness, self.augment_contrast,
                self.augment_hue, self.augment_saturation)
            arr, boxes = self._geometric_augment(arr, boxes)
            target = np.concatenate([boxes, categories], axis=1)
            # stride padding happens once at batch collation
            # (loader._pad_batch), not per image
            return arr, target

        if self.training and self.emit == 'u8':
            # transfer-thin feed: raw u8 pixels + the per-image color
            # affine; jitter+normalize runs on-device (color_affine)
            arr, ratio = self._load_resized_u8(img_id, resize)
            boxes, categories = self._get_target(img_id)
            boxes = self._scale_boxes(boxes, ratio)
            t, off = self._draw_color_affine(arr)
            arr, boxes = self._geometric_augment(arr, boxes)
            target = np.concatenate([boxes, categories], axis=1)
            return arr, target, t, off

        if not self.training and self.emit == 'u8':
            # transfer-thin eval feed: raw u8 pixels; the constant
            # normalize affine runs on-device (infer.py wraps
            # inference_fn with it)
            arr, ratio = self._load_resized_u8(img_id, resize)
            return arr, img_id, ratio

        # training interleaves color jitter between decode and normalize,
        # so the fused native normalize is only used at eval time
        arr, ratio, normalized = self._load_resized(
            img_id, resize, normalize=not self.training)

        if self.training:
            boxes, categories = self._get_target(img_id)
            boxes = self._scale_boxes(boxes, ratio)
            # color first: the jitter matmul wants the contiguous decode
            # output (a flipped view is ~4x slower through BLAS), and the
            # pixelwise color ops commute with flips/rotations
            arr = _color_jitter_normalize(
                arr, self.augment_brightness, self.augment_contrast,
                self.augment_hue, self.augment_saturation)
            arr, boxes = self._geometric_augment(arr, boxes)
            target = np.concatenate([boxes, categories], axis=1)
        elif not normalized:
            arr = _normalize_eval(arr)

        # The reference pads each image to the stride here
        # (data.py:122-123); we defer all padding to batch collation
        # (loader._pad_batch rounds the batch max up to the stride), so
        # the image is copied exactly once into the batch canvas.
        if self.training:
            return arr, target
        return np.asarray(arr, np.float32), img_id, ratio

    def _scale_boxes(self, boxes, ratio):
        boxes = boxes.copy()
        boxes[:, :4] *= ratio
        return boxes

    @staticmethod
    def _rot90_same_canvas(arr, k, fill=0.0):
        """CCW rotate by k*90deg keeping the original canvas (center
        crop/pad) — PIL's Image.rotate(angle) without expand. ``fill``
        is the padding value: black in raw pixel space, but when the
        input is already normalized (color runs before geometric here)
        the caller passes black's normalized value instead."""
        h, w = arr.shape[:2]
        rot = np.rot90(arr, k)
        canvas = np.full((h, w, arr.shape[2]), fill, arr.dtype)
        rh, rw = rot.shape[:2]
        # center alignment: source and destination offsets
        dy, dx = (h - rh) // 2, (w - rw) // 2
        sy, sx = max(0, -dy), max(0, -dx)
        dy, dx = max(0, dy), max(0, dx)
        ch = min(rh - sy, h - dy)
        cw = min(rw - sx, w - dx)
        canvas[dy:dy + ch, dx:dx + cw] = rot[sy:sy + ch, sx:sx + cw]
        return canvas

    def _geometric_augment(self, arr, boxes):
        # 90-degree-step rotation (data.py:67-86): same-canvas like
        # PIL rotate without expand
        angle = random.randint(0, 3) * 90
        if self.rotate_augment and angle != 0:
            # f32 emit: the array is normalized by now (color runs
            # first), so pad with black's normalized value — the
            # reference rotates raw pixels and the zero fill then flows
            # through its jitter+normalize chain (exact at zero contrast
            # jitter, within c/std of it otherwise). u8 emit: raw black,
            # which flows through the on-device affine exactly like the
            # reference's.
            fill = 0 if self.emit == 'u8' else _CLIP_LO
            arr = self._rot90_same_canvas(arr, angle // 90, fill=fill)
            h, w = arr.shape[:2]
            x, y, bw, bh = (boxes[:, i].copy() for i in range(4))
            if angle == 90:
                boxes[:, 0] = y - h / 2 + w / 2
                boxes[:, 1] = w / 2 + h / 2 - x - bw
                boxes[:, 2], boxes[:, 3] = bh, bw
            elif angle == 180:
                boxes[:, 0] = w - x - bw
                boxes[:, 1] = h - y - bh
            elif angle == 270:
                boxes[:, 0] = w / 2 + h / 2 - y - bh
                boxes[:, 1] = x - w / 2 + h / 2
                boxes[:, 2], boxes[:, 3] = bh, bw
        # horizontal flip (data.py:87-90)
        if random.randint(0, 1):
            arr = arr[:, ::-1]
            boxes[:, 0] = arr.shape[1] - boxes[:, 0] - boxes[:, 2]
        return arr, boxes


class RotatedCocoDataset(CocoDataset):
    """Rotated-box dataset: targets are (x, y, w, h, theta, class)
    (odtk/data.py:237-430)."""
    box_width = 6

    def _prep_bbox(self, bbox, img_id):
        if len(bbox) == 4:
            return bbox + [0.0]
        assert len(bbox) == 5, \
            f'Bounding box for image {img_id} must have 5 entries'
        return bbox[:5]

    def _scale_boxes(self, boxes, ratio):
        boxes = boxes.copy()
        boxes[:, :4] *= ratio      # theta unscaled (data.py:291)
        return boxes

    def _geometric_augment(self, arr, boxes):
        angle = random.randint(0, 3) * 90
        if self.rotate_augment and angle != 0:
            oh, ow = arr.shape[:2]
            arr = np.rot90(arr, angle // 90)   # expand=True semantics
            x, y, bw, bh, t = (boxes[:, i].copy() for i in range(5))
            if angle == 90:
                boxes[:, 0] = y
                boxes[:, 1] = ow - x - bw
                if not self.absolute_angle:
                    boxes[:, 2], boxes[:, 3] = bh, bw
            elif angle == 180:
                boxes[:, 0] = ow - x - bw
                boxes[:, 1] = oh - y - bh
            elif angle == 270:
                boxes[:, 0] = oh - y - bh
                boxes[:, 1] = x
                if not self.absolute_angle:
                    boxes[:, 2], boxes[:, 3] = bh, bw
            if self.absolute_angle:
                t = t + math.radians(angle)
                boxes[:, 4] = np.sign(t) * np.remainder(np.abs(t), math.pi)
        if random.randint(0, 1):
            arr = arr[:, ::-1]
            boxes[:, 0] = arr.shape[1] - boxes[:, 0] - boxes[:, 2]
            boxes[:, 4] = -boxes[:, 4]
        return arr, boxes
