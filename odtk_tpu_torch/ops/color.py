"""Colour math of the u8 and yuv420 feeds, on the device.

Counterpart of ``odtk_tpu/ops/color.py``: ``apply_color_affine`` and
``apply_color_affine_yuv`` (train), ``eval_normalize_u8`` and
``eval_normalize_yuv`` (eval). The loader ships raw u8 pixels (a quarter
of the f32 bytes over PCIe) or YCbCr 4:2:0 planes (an eighth), and the
chroma upsample, the per-image colour affine, the clip and the pad
masking run as tensor ops next to the model, in fp32.
"""

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
# the [0, 1] pixel range after normalization
_CLIP_LO = (0.0 - IMAGENET_MEAN) / IMAGENET_STD
_CLIP_HI = (1.0 - IMAGENET_MEAN) / IMAGENET_STD


def apply_color_affine(images_u8, colors, sizes):
    """Per-image colour affine of the u8 train feed, then clip and pad
    masking. images_u8 [B, H, W, 3]; ``colors`` [B, 3, 4], each image's
    folded jitter+normalize affine (``data/coco.color_affine``): [:, :, :3]
    the matrix, [:, :, 3] the offset; ``sizes`` [B, 2], the valid (h, w).
    Padding is zeroed in normalized space, as in the f32 feed. Three
    multiply-adds in the JAX function's order, in fp32."""
    x = images_u8.float()
    colors = colors.to(x.device, torch.float32)
    t = colors[:, :, :3][:, None, None]         # [B, 1, 1, 3(c), 3(d)]
    y = (x[..., 0:1] * t[..., 0, :] + x[..., 1:2] * t[..., 1, :]
         + x[..., 2:3] * t[..., 2, :]) + colors[:, None, None, :, 3]
    # per-channel clip with host scalars: a host -> device copy of the
    # bounds would synchronize the stream on every step
    y = torch.cat([y[..., c:c + 1].clamp(float(_CLIP_LO[c]),
                                         float(_CLIP_HI[c]))
                   for c in range(3)], dim=-1)
    return _mask_valid(y, images_u8.shape[1:3], sizes)


def apply_color_affine_yuv(y_u8, cbcr_u8, colors, sizes):
    """The yuv420 train feed: y_u8 [B, H, W] and cbcr_u8
    [B, H/2, W/2, 2] assembled by a nearest 2x upsample of the chroma,
    then ``apply_color_affine``, whose ``colors`` the loader already
    folded through YCbCr -> RGB (``data/loader.fold_yuv_affine``)."""
    c = cbcr_u8.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yuv = torch.cat([y_u8[..., None], c], dim=-1)
    return apply_color_affine(yuv, colors, sizes)


def eval_normalize_yuv(y_u8, cbcr_u8, sizes):
    """The yuv420 eval feed: the planes assembled as in
    ``apply_color_affine_yuv`` under one constant affine, the ImageNet
    normalization folded through YCbCr -> RGB; NHWC fp32 with the canvas
    padding zeroed. Chroma is 2x2-averaged, like the JPEG's own, so this
    is slightly lossy against ``eval_normalize_u8``."""
    from ..data.loader import fold_yuv_affine

    t = np.diag(1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
    off = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)
    colors = torch.from_numpy(fold_yuv_affine(
        np.concatenate([t, off[:, None]], axis=1)[None])).to(y_u8.device)
    return apply_color_affine_yuv(
        y_u8, cbcr_u8, colors.expand(y_u8.shape[0], 3, 4), sizes)


def eval_normalize_u8(images_u8, sizes):
    """u8 [B, H, W, 3] -> (x/255 - mean)/std in fp32, NHWC, with the
    canvas padding outside each image's valid (h, w) in ``sizes`` [B, 2]
    zeroed."""
    x = images_u8.float()
    scale = torch.from_numpy(1.0 / (255.0 * IMAGENET_STD)).to(x.device)
    off = torch.from_numpy(-IMAGENET_MEAN / IMAGENET_STD).to(x.device)
    return _mask_valid(x * scale + off, images_u8.shape[1:3], sizes)


def _mask_valid(y, hw, sizes):
    h, w = hw
    sizes = sizes.to(y.device)
    rows = torch.arange(h, device=y.device)
    cols = torch.arange(w, device=y.device)
    valid = ((rows[None, :, None] < sizes[:, 0, None, None])
             & (cols[None, None, :] < sizes[:, 1, None, None]))
    return y * valid[..., None].to(y.dtype)
