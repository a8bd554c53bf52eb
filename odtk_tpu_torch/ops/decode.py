"""Box decoding and top-k filtering of the FPN heads.

Counterpart of ``odtk_tpu/ops/decode.py`` on the model's path
(``from_logits=True``, an anchor table given), axis-aligned or rotated:
a rotated box head has 6 channels per anchor and its boxes come out as
(x1, y1, x2, y2, sin, cos), the raw (sin, cos) carried through. Heads
are NHWC, [B, H, W, A*K] logits with channel c = a*K + k (anchor-major,
class-minor), as the JAX package and the reference checkpoints lay them
out. Selection is ``torch.topk`` (exact); the JAX package's lane padding
and ``approx_max_k`` exist for the TPU and change no result.

Slots below the score threshold come back with score, class and box
zeroed, the zero-score-is-empty convention that NMS reads.
"""

import torch


def _boxes_from_deltas(deltas, anc, w, h, stride):
    """Anchor-relative center/size decode with one-sided clamping
    (``odtk_tpu/ops/decode.py:_boxes_from_deltas``); deltas with 6
    channels carry their (sin, cos) through."""
    aw = anc[..., 2:4] - anc[..., 0:2] + 1
    actr = anc[..., 0:2] + 0.5 * aw
    pred_ctr = deltas[..., 0:2] * aw + actr
    pred_wh = torch.exp(deltas[..., 2:4]) * aw
    lim = torch.tensor([w * stride - 1, h * stride - 1], dtype=torch.float32,
                       device=deltas.device)
    lo = torch.clamp(pred_ctr - 0.5 * pred_wh, min=0.0)
    hi = torch.minimum(pred_ctr + 0.5 * pred_wh - 1.0, lim)
    return torch.cat([lo, hi, deltas[..., 4:]], dim=-1)


def _select(logits, threshold):
    """Sigmoid of the selected logits only, in fp32, and the threshold
    mask (top-k is monotonic, so selecting on logits picks the same
    candidates as selecting on scores)."""
    scores = torch.sigmoid(logits.float())
    return scores, scores > threshold


def decode(cls_head, box_head, stride, anchors, threshold=0.05, top_n=1000,
           rotated=False):
    """Decode one level's heads into (scores, boxes, classes).

    cls_head [B, H, W, A*K] logits; box_head [B, H, W, A*nb] deltas (nb
    = 4, or 6 rotated); anchors [A, 4] table (for a rotated model the
    axis half of its pair). Returns scores [B, n], boxes [B, n, nb],
    classes [B, n] with n = min(top_n, H*W*A*K).
    """
    nb = 6 if rotated else 4
    b, h, w, chans = cls_head.shape
    a = box_head.shape[-1] // nb
    k = chans // a
    top_n = min(top_n, h * w * chans)
    logits, idx = torch.topk(cls_head.reshape(b, -1), top_n, dim=1)
    scores, keep = _select(logits, threshold)

    kk = idx % k
    aa = (idx // k) % a
    ww = (idx // (k * a)) % w
    hh = idx // (k * a * w)
    deltas = torch.gather(box_head.reshape(b, h * w * a, nb), 1,
                          (idx // k)[..., None].expand(-1, -1, nb)).float()
    table = torch.as_tensor(anchors, dtype=torch.float32, device=idx.device)
    cell = torch.stack([ww, hh, ww, hh], dim=-1).float() * stride
    box = _boxes_from_deltas(deltas, cell + table[aa], w, h, stride)
    return (torch.where(keep, scores, 0.0),
            torch.where(keep[..., None], box, 0.0),
            torch.where(keep, kk.float(), 0.0))


def decode_fused(cls_heads, box_heads, strides, anchor_tables,
                 threshold=0.05, top_n=1000, total_top_n=None, rotated=False):
    """All levels with ONE global top-k of ``total_top_n`` (default
    ``top_n`` x levels) over the concatenated score maps, then each
    candidate mapped back to its (level, cell, anchor, class).

    Same contract as ``decode``; the global budget is the JAX package's
    deliberate divergence from per-level caps (``odtk_tpu/ops/decode.py:
    decode_fused``): whenever fewer candidates pass the threshold than
    the budget, the candidate sets are identical.
    """
    nb = 6 if rotated else 4
    b = cls_heads[0].shape[0]
    k = cls_heads[0].shape[-1] // (box_heads[0].shape[-1] // nb)
    flat = torch.cat([ch.reshape(b, -1) for ch in cls_heads], dim=1)
    total = min(total_top_n or top_n * len(cls_heads), flat.shape[1])
    logits, idx = torch.topk(flat, total, dim=1)
    scores, keep = _select(logits, threshold)

    out_box = scores.new_zeros(b, total, nb)
    out_cls = scores.new_zeros(b, total)
    off = 0
    for ch, bh, stride, table in zip(cls_heads, box_heads, strides,
                                     anchor_tables):
        _, h, w, chans = ch.shape
        a = chans // k
        local = idx - off
        in_level = (local >= 0) & (local < h * w * chans)
        local = torch.where(in_level, local, 0)
        c = local % chans
        row = local // chans
        kk = c % k
        aa = c // k
        ww = row % w
        hh = row // w
        deltas = torch.gather(bh.reshape(b, h * w * a, nb), 1,
                              (row * a + aa)[..., None].expand(-1, -1, nb))
        tbl = torch.as_tensor(table, dtype=torch.float32, device=idx.device)
        cell = torch.stack([ww, hh, ww, hh], dim=-1).float() * stride
        box = _boxes_from_deltas(deltas.float(), cell + tbl[aa], w, h, stride)
        out_box = torch.where(in_level[..., None], box, out_box)
        out_cls = torch.where(in_level, kk.float(), out_cls)
        off += h * w * chans

    return (torch.where(keep, scores, 0.0),
            torch.where(keep[..., None], out_box, 0.0),
            torch.where(keep, out_cls, 0.0))
