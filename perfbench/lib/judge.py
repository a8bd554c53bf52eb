"""The numbers that decide ``correct``: what the timed path produced,
judged by the plain reference.

Training (``train_numbers``): the three first steps' losses, the first
gradient as the optimizer holds it after one step (the momentum buffer,
gradient plus weight decay), and the parameters' change after three
steps, each leaf's norm against the reference's, measured against that
leaf's reference norm or the median leaf's, whichever is larger: the
worst leaf's gap (``grad_gap``, ``update_gap``), the median leaf's
(``grad_gap_median``, ``update_gap_median``, steadier where bf16's own
noise reaches the worst leaf) and the update's 90th percentile over the
leaves (``update_gap_q90``: a fault in a tenth of the leaves or more
reaches it). Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the change (they move by round-off
alone). A cell's limits name the numbers it compares.

Serving (``detection_numbers``): each detection's box is held to the
nearest of the reference's decoded boxes, the gap measured against that
box's anchor's longer side (the scale the box head's deltas act at; a
box clamped at the canvas's edge can be far smaller), and its logit to the
reference's at an anchor traced back from it: of the anchors whose box
lies within ``BOX_SLACK`` of the box's size of the nearest (boxes clamped
at the canvas's edges coincide), the one whose logit for the
detection's class lies nearest. The detections' largest same-class IoU
is held to the configuration's NMS threshold.

The selection (``select_gap``) is held to the reference's candidates,
the ``fused_top_n`` largest logits over all anchors and classes whose
score clears the threshold: each one has to be a detection, or be
suppressed by a detection of its class that overlaps it by more than the
NMS threshold (less ``IOU_SLACK``, the boxes' rounding) and scores as
high, or score under the lowest detection when ``detections`` are
returned (under the threshold when fewer are). A candidate that is none
of these reads how far its reference logit lies above the highest that
would explain it: the detections' logits are the reference's at the
anchors traced back from them, and the overlaps are the reference's
boxes', so the number reads no more than the logits' rounding where the
program keeps one of two near-equal candidates, and a best candidate
dropped, an over-wide suppression or a short list reads the gap to the
detections it should have stood among.
"""

import math
import statistics

import torch

from perfbench.reference import retinanet as ref

BOX_SLACK = 0.05
IOU_SLACK = 0.05


def rel_gap(got, want, floor):
    return abs(got - want) / max(abs(want), floor)


def train_numbers(program, reference):
    """program / reference: dicts with ``losses`` [(cls, box)] a step,
    ``grad_norms`` and ``update_norms`` a leaf; the reference also has
    ``grad_only`` (the gradient's norm without weight decay)."""
    loss_gap = max(rel_gap(p, r, 1e-12)
                   for ps, rs in zip(program['losses'], reference['losses'])
                   for p, r in zip(ps, rs))
    g_ref = reference['grad_norms']
    med = statistics.median(g_ref)
    grad = [rel_gap(p, r, med) for p, r in zip(program['grad_norms'], g_ref)]
    only = reference['grad_only']
    cut = 1e-3 * statistics.median(only)
    kept = [i for i, g in enumerate(only) if g >= cut]
    u_ref = [reference['update_norms'][i] for i in kept]
    med_u = statistics.median(u_ref)
    update = [rel_gap(program['update_norms'][i], r, med_u)
              for i, r in zip(kept, u_ref)]
    return {'loss_gap': loss_gap, 'grad_gap': max(grad),
            'update_gap': max(update),
            'grad_gap_median': statistics.median(grad),
            'update_gap_median': statistics.median(update),
            'update_gap_q90': statistics.quantiles(update, n=10)[-1]}


def _logit(s):
    s = s.double()
    return torch.log(s) - torch.log1p(-s)


def _pair_iou(a, b):
    """IoU [..., N, M] in fp32, in the order the NMS computes it."""
    x1, y1, x2, y2 = (v[..., :, None] for v in b.unbind(-1))
    ax1, ay1, ax2, ay2 = (v[..., None, :] for v in a.unbind(-1))
    iw = (torch.minimum(x2, ax2) - torch.maximum(x1, ax1) + 1).clamp(min=0)
    ih = (torch.minimum(y2, ay2) - torch.maximum(y1, ay1) + 1).clamp(min=0)
    inter = iw * ih
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    marea = (ax2 - ax1 + 1) * (ay2 - ay1 + 1)
    return inter / (area + marea - inter)


def detection_numbers(dets, logits, boxes, sides, config):
    """dets: the program's (scores [B, D], boxes [B, D, 4], classes
    [B, D]); logits [B, N, K] and boxes [B, N, 4]: the reference's over
    every anchor; sides [N]: each anchor's longer side. Returns the four
    numbers."""
    scores, det_boxes, det_cls = (t.to(logits.device).float() for t in dets)
    b, d = scores.shape
    k = logits.shape[-1]
    live = scores > 0
    out = {'logit_gap': 0.0, 'box_gap': 0.0, 'nms_overlap': 0.0,
           'select_gap': 0.0}
    cls_ok = (det_cls == det_cls.round()) & (det_cls >= 0) & (det_cls < k)
    cls = torch.where(cls_ok, det_cls, 0).long()
    anchor = torch.zeros(b, d, dtype=torch.long, device=logits.device)
    zp = _logit(scores).float()
    for i in range(b):
        dist = (boxes[i][None] - det_boxes[i][:, None]).abs().amax(-1)
        near, nearest = dist.min(dim=1)
        db = det_boxes[i]
        size = torch.maximum(db[:, 2] - db[:, 0], db[:, 3] - db[:, 1]) + 1
        close = dist <= (near + BOX_SLACK * size)[:, None]
        zc = logits[i][:, cls[i]].T                       # [D, N]
        miss = torch.where(close, (zc - zp[i][:, None]).abs(), math.inf)
        anchor[i] = miss.argmin(dim=1)
        gap = torch.where(live[i], near / sides[nearest], 0.0)
        out['box_gap'] = max(out['box_gap'], float(gap.max()))
    z = torch.gather(logits.reshape(b, -1), 1, anchor * k + cls).double()
    bad = live & ~cls_ok
    lg = torch.where(live, (_logit(scores) - z).abs(), 0.0)
    lg = torch.where(bad | ~torch.isfinite(lg), math.inf, lg)
    out['logit_gap'] = float(lg.max())
    for i in range(b):
        out['select_gap'] = max(out['select_gap'], _select_gap(
            logits[i], boxes[i], boxes[i][anchor[i]], cls[i], z[i].float(),
            live[i] & cls_ok[i], config))

    same = det_cls[:, :, None] == det_cls[:, None, :]
    pair = live[:, :, None] & live[:, None, :] & same & torch.triu(
        torch.ones(d, d, dtype=torch.bool, device=logits.device), 1)
    overlap = torch.where(pair, _pair_iou(det_boxes, det_boxes), 0.0)
    out['nms_overlap'] = float(overlap.max()) if d else 0.0
    return out


def _select_gap(logits, boxes, det_boxes, det_cls, det_z, live, config):
    """One image's selection gap: logits [N, K], boxes [N, 4] the
    reference's; det_boxes [D, 4], det_z [D] the reference's at the
    detections' anchors, det_cls [D], live [D]."""
    k = logits.shape[-1]
    zc, idx = torch.topk(logits.reshape(-1), config['fused_top_n'])
    cand = torch.sigmoid(zc) > config['threshold']
    over = ref.iou(boxes[idx // k], det_boxes) > config['nms'] - IOU_SLACK
    explains = over & live[None] & (det_cls[None] == (idx % k)[:, None])
    cover = torch.where(explains, det_z[None], -math.inf).amax(1)
    if int(live.sum()) >= config['detections']:
        floor = float(det_z[live].min())
    else:
        t = config['threshold']
        floor = math.log(t) - math.log1p(-t)
    excess = torch.where(cand, zc - cover.clamp(min=floor), 0.0)
    return max(0.0, float(excess.max()))


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit (NaN fails)."""
    checks = [(name, float(numbers[name]), float(limits[name]))
              for name in limits]
    return all(v <= lim for _, v, lim in checks), checks
