"""Rotated anchor matching: the CUDA kernel (csrc/match_rotated.cu) and
its plain PyTorch versions, for two entry points.

- ``rotated_match`` replaces the TPU kernel
  ``odtk_tpu/ops/pallas/match_rotated_kernel.py:rotated_match_pallas``,
  the batched matcher of every rotated training step: anchors [N, 8]
  shared across the batch, per image the packed rows [B, M, 9] (quad and
  original slot, the first n_act[b] active, in ascending slot order), ->
  (best_iou [B, N], best_slot [B, N] int32), a strict ``>`` fold from
  (-2, slot 0). The plain version is the JAX package's stream (the jnp
  form of ``rotated_best_match_batched``), with no tile skip.
- ``rotated_best_match`` replaces
  ``odtk_tpu/ops/pallas/iou_kernel.py:rotated_best_match_pallas`` with
  the semantics of the jnp ``rotated_best_match`` it stands for: one
  image, every target visited, an invalid one counting as IoU -1,
  (best_iou [N], best_idx [N] int32). The same kernel with its skip,
  band and packing turned off.

What the kernel and its plain version share, and where they differ.
Both clip by ``_soa_clip_iou``'s arithmetic and fold in the same order,
so each IoU they compute is the same bit for bit. The kernel skips a
target for a tile of 256 anchors whose AABB misses the target's (its IoU
against every anchor of the tile is 0), so the anchors that no target
reached, and keep (-2, slot 0), are not the plain version's, nor the TPU
kernel's (its tiles are 16 x 128). Wherever the plain best IoU is > 0
the kernel's equals it, IoU and slot; everywhere else both are <= 0,
below the background threshold ``lo``. So the assignment's ``depth`` is
equal everywhere, and its class and deltas wherever ``depth > 0``: what
the loss reads. ``tests/test_torch_kernels.py`` and ``chip_smoke.py``
hold the kernel to exactly that.

The wrappers take the plain version for tensors on the CPU and the
kernel for CUDA tensors; there is no fallback between them.
"""

import torch

from ..iou_rotated import _corner_lists, clip_iou
from . import _build

MAX_ROWS = 6400            # 36 bytes each of shared memory per block


def rotated_match_plain(anchors, rows, n_act):
    """The stream: per image, its active rows in order, each clipped
    against every anchor and folded with a strict ``>``."""
    b, n = rows.shape[0], anchors.shape[0]
    best_iou = anchors.new_full((b, n), -2.0)
    best_slot = torch.zeros((b, n), dtype=torch.int32, device=anchors.device)
    steps = int(n_act.max()) if b else 0
    for t in range(steps):
        row = rows[:, t]                                   # [B, 9]
        cx, cy = _corner_lists(row[:, :8], 1)              # [B, 1] each
        iou = clip_iou(anchors, cx, cy)                    # [B, N]
        upd = (t < n_act.to(anchors.device))[:, None] & (iou > best_iou)
        best_iou = torch.where(upd, iou, best_iou)
        best_slot = torch.where(upd, row[:, 8:9].to(torch.int32), best_slot)
    return best_iou, best_slot


def rotated_best_match_plain(anchors, clips, valid):
    """Best (IoU, index) of anchors [N, 8] vs clips [M, 8]; an invalid
    clip counts as IoU -1 (``odtk_tpu/ops/iou_rotated.py:230-253``)."""
    n = anchors.shape[0]
    best_iou = anchors.new_full((n,), -2.0)
    best_idx = torch.zeros(n, dtype=torch.int32, device=anchors.device)
    for i in range(clips.shape[0]):
        cx, cy = _corner_lists(clips[i], 0)
        iou = torch.where(valid[i], clip_iou(anchors, cx, cy), -1.0)
        upd = iou > best_iou
        best_iou = torch.where(upd, iou, best_iou)
        best_idx = torch.where(upd, i, best_idx)
    return best_iou, best_idx


def _check_anchors(anchors, name):
    if (anchors.device.type != 'cuda' or anchors.dim() != 2
            or anchors.shape[1] != 8):
        raise ValueError(f'{name}: anchors must be a CUDA [N, 8] tensor, got '
                         f'{tuple(anchors.shape)} on {anchors.device}')
    return anchors.float().contiguous()


def rotated_match(anchors, rows, n_act):
    """Batched best match: the plain version on the CPU, the kernel on
    CUDA. anchors [N, 8], rows [B, M, 9], n_act [B] ->
    (best_iou [B, N] fp32, best_slot [B, N] int32)."""
    if anchors.device.type == 'cpu':
        return rotated_match_plain(anchors.float(), rows.float(), n_act)
    anchors = _check_anchors(anchors, 'rotated_match')
    b, m = rows.shape[:2]
    if (rows.dim() != 3 or rows.shape[2] != 9 or n_act.shape != (b,)
            or rows.device != anchors.device
            or n_act.device != anchors.device or m > MAX_ROWS):
        raise ValueError(f'rotated_match: rows {tuple(rows.shape)} and n_act '
                         f'{tuple(n_act.shape)} on {rows.device}, '
                         f'{n_act.device} (at most {MAX_ROWS} rows)')
    rows = rows.float().contiguous()
    n_act = n_act.to(torch.int32).contiguous()
    n = anchors.shape[0]
    best_iou = anchors.new_empty(b, n)
    best_slot = torch.empty((b, n), dtype=torch.int32, device=anchors.device)
    if b == 0 or n == 0:
        return best_iou, best_slot
    with torch.cuda.device(anchors.device):
        rc = _build.library().odtk_match_rotated(
            anchors.data_ptr(), rows.data_ptr(), n_act.data_ptr(), b, n, m,
            best_iou.data_ptr(), best_slot.data_ptr(),
            _build.stream_handle(anchors.device))
    _build.check(rc, 'odtk_match_rotated')
    rotated_match.launches += 1
    return best_iou, best_slot


def rotated_best_match(anchors, clips, valid):
    """Best match of one image: the plain version on the CPU, the kernel
    on CUDA. anchors [N, 8], clips [M, 8], valid [M] ->
    (best_iou [N] fp32, best_idx [N] int32)."""
    if anchors.device.type == 'cpu':
        return rotated_best_match_plain(anchors.float(), clips.float(),
                                        valid.bool())
    anchors = _check_anchors(anchors, 'rotated_best_match')
    m = clips.shape[0]
    if (clips.shape != (m, 8) or valid.shape != (m,) or m > MAX_ROWS
            or clips.device != anchors.device
            or valid.device != anchors.device):
        raise ValueError(f'rotated_best_match: clips {tuple(clips.shape)}, '
                         f'valid {tuple(valid.shape)} (at most {MAX_ROWS})')
    rows = torch.cat([clips.float(), valid.float()[:, None]], 1).contiguous()
    n = anchors.shape[0]
    best_iou = anchors.new_empty(n)
    best_idx = torch.empty(n, dtype=torch.int32, device=anchors.device)
    if n == 0:
        return best_iou, best_idx
    with torch.cuda.device(anchors.device):
        rc = _build.library().odtk_rotated_best_match(
            anchors.data_ptr(), rows.data_ptr(), n, m, best_iou.data_ptr(),
            best_idx.data_ptr(), _build.stream_handle(anchors.device))
    _build.check(rc, 'odtk_rotated_best_match')
    rotated_best_match.launches += 1
    return best_iou, best_idx


rotated_match.launches = 0
rotated_best_match.launches = 0
