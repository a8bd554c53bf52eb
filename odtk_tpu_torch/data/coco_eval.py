"""COCO mAP/mAR evaluation, pycocotools-free.

A copy of ``odtk_tpu/data/coco_eval.py``: the port imports nothing of
``odtk_tpu``, and ``tests/test_torch_data.py`` holds the two equal. The
COCOeval protocol: IoU thresholds 0.50:0.05:0.95, 101-point
interpolated precision, area ranges all/small/medium/large, maxDets
1/10/100, crowd-aware matching; the standard 12-element stats vector.
iou_type 'bbox' uses xywh box IoU; 'segm' uses exact convex-polygon IoU.
"""

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {'all': (0.0, 1e10), 'small': (0.0, 32.0 ** 2),
             'medium': (32.0 ** 2, 96.0 ** 2), 'large': (96.0 ** 2, 1e10)}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(dts, gts, iscrowd):
    """IoU matrix [n_dt, n_gt] for xywh boxes; crowd gts use inter/area_dt."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    d = np.asarray(dts, np.float64)
    g = np.asarray(gts, np.float64)
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix = (np.minimum(dx2[:, None], gx2) -
          np.maximum(d[:, None, 0], g[:, 0])).clip(0)
    iy = (np.minimum(dy2[:, None], gy2) -
          np.maximum(d[:, None, 1], g[:, 1])).clip(0)
    inter = ix * iy
    da = (d[:, 2] * d[:, 3])[:, None]
    ga = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(np.asarray(iscrowd)[None, :], da, da + ga - inter)
    with np.errstate(divide='ignore', invalid='ignore'):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def _poly_area(p):
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _signed_area(p):
    x, y = p[:, 0], p[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _poly_clip(subject, clip):
    # normalize clip orientation so the `fp <= 0` half-plane test keeps
    # the interior regardless of winding
    clip = np.asarray(clip, np.float64)
    if _signed_area(clip) < 0:
        clip = clip[::-1]
    out = list(map(tuple, subject))
    for i in range(len(clip)):
        v1, v2 = clip[i], clip[(i + 1) % len(clip)]
        a, b = v2[1] - v1[1], v1[0] - v2[0]
        c = v2[0] * v1[1] - v2[1] * v1[0]
        inp, out = out, []
        for j in range(len(inp)):
            p, q = inp[j], inp[(j + 1) % len(inp)]
            fp = a * p[0] + b * p[1] + c
            fq = a * q[0] + b * q[1] + c
            if fp <= 0:
                out.append(p)
            if fp * fq < 0:
                t = fp / (fp - fq)
                out.append((p[0] + t * (q[0] - p[0]),
                            p[1] + t * (q[1] - p[1])))
        if not out:
            return []
    return out


def poly_iou(dt_polys, gt_polys, iscrowd):
    """IoU matrix for convex polygons given as flat [x0,y0,...] lists."""
    iou = np.zeros((len(dt_polys), len(gt_polys)))
    dts = [np.asarray(p, np.float64).reshape(-1, 2) for p in dt_polys]
    gts = [np.asarray(p, np.float64).reshape(-1, 2) for p in gt_polys]
    for i, d in enumerate(dts):
        da = _poly_area(d)
        for j, g in enumerate(gts):
            clipped = _poly_clip(d, g)
            inter = (_poly_area(np.asarray(clipped))
                     if len(clipped) > 2 else 0.0)
            if iscrowd[j]:
                denom = da
            else:
                denom = da + _poly_area(g) - inter
            iou[i, j] = inter / denom if denom > 0 else 0.0
    return iou


class CocoEvaluator:
    """Evaluate detection dicts against a CocoIndex ground truth.

    detections: iterable of {image_id, category_id, score, bbox xywh,
    [segmentation]} — the exact JSON schema the reference writes
    (infer.py:138-148).
    """

    def __init__(self, coco_index, iou_type='bbox'):
        self.coco = coco_index
        self.iou_type = iou_type

    # ---------------------------------------------------------------- match
    def _gt_for(self, img_id, cat_id):
        anns = [a for a in self.coco.load_anns(img_id)
                if a['category_id'] == cat_id]
        return anns

    def _ious(self, dts, gts):
        iscrowd = [int(g.get('iscrowd', 0)) for g in gts]
        if self.iou_type == 'bbox':
            return box_iou_xywh([d['bbox'] for d in dts],
                                [g['bbox'] for g in gts], iscrowd)
        dt_polys = [np.asarray(d['segmentation'][0], np.float64)
                    for d in dts]
        gt_polys = []
        for g in gts:
            if 'segmentation' in g and g['segmentation']:
                gt_polys.append(np.asarray(g['segmentation'][0], np.float64))
            else:
                x, y, w, h = g['bbox'][:4]
                theta = g['bbox'][4] if len(g['bbox']) > 4 else 0.0
                cx, cy = x + (w - 1) / 2, y + (h - 1) / 2
                cs, sn = np.cos(theta), np.sin(theta)
                base = np.array([[x, y], [x, y + h - 1],
                                 [x + w - 1, y + h - 1], [x + w - 1, y]])
                rot = (base - [cx, cy]) @ np.array([[cs, sn], [-sn, cs]])
                gt_polys.append((rot + [cx, cy]).reshape(-1))
        return poly_iou(dt_polys, gt_polys, iscrowd)

    def _evaluate_img(self, dts, gts, ious, area_rng, max_det):
        T = len(IOU_THRS)
        dts = dts[:max_det]
        n_d, n_g = len(dts), len(gts)
        # pycocotools boundary semantics: ignore iff a < lo or a > hi
        # (inclusive at BOTH ends — an area of exactly 32^2 counts as
        # both small and medium)
        gt_ig = np.array([
            1 if (g.get('iscrowd', 0) or self._gt_area(g) < area_rng[0]
                  or self._gt_area(g) > area_rng[1]) else 0
            for g in gts], np.int32)
        order = np.argsort(gt_ig, kind='stable')   # ignored last
        gts_s = [gts[i] for i in order]
        gt_ig = gt_ig[order]
        ious_s = ious[:, order][:len(dts)] if n_g else ious[:len(dts)]

        dtm = np.zeros((T, n_d), np.int64)
        gtm = np.zeros((T, n_g), np.int64)
        dt_ig = np.zeros((T, n_d), np.int32)
        for ti, t in enumerate(IOU_THRS):
            for di in range(n_d):
                best, m = min(t, 1 - 1e-10), -1
                for gi in range(n_g):
                    if gtm[ti, gi] > 0 and not gts_s[gi].get('iscrowd', 0):
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious_s[di, gi] < best:
                        continue
                    best, m = ious_s[di, gi], gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dtm[ti, di] = m + 1
                gtm[ti, m] = di + 1
        # unmatched dts outside the area range are ignored
        dt_out = np.array([
            1 if (self._dt_area(d) < area_rng[0]
                  or self._dt_area(d) > area_rng[1]) else 0
            for d in dts], np.int32)
        dt_ig = np.logical_or(dt_ig, (dtm == 0) & dt_out[None, :])
        n_ok_gt = int((gt_ig == 0).sum())
        scores = np.array([d['score'] for d in dts], np.float64)
        return dtm > 0, dt_ig, scores, n_ok_gt

    def _gt_area(self, g):
        if 'area' in g:
            return float(g['area'])
        b = g['bbox']
        return float(b[2] * b[3])

    def _dt_area(self, d):
        # segm eval measures the detection by its mask/polygon area
        # (pycocotools: d['area'] = maskUtils.area(d['segmentation']));
        # bbox eval by w*h
        if self.iou_type == 'segm' and d.get('segmentation'):
            p = np.asarray(d['segmentation'][0], np.float64).reshape(-1, 2)
            return float(_poly_area(p))
        b = d['bbox']
        return float(b[2] * b[3])

    # ------------------------------------------------------------ accumulate
    def evaluate(self, detections, verbose=False):
        img_ids = self.coco.get_img_ids()
        cat_ids = self.coco.get_cat_ids() or sorted(
            {d['category_id'] for d in detections})
        by_img_cat = {}
        for d in detections:
            by_img_cat.setdefault((d['image_id'], d['category_id']),
                                  []).append(d)
        for v in by_img_cat.values():
            v.sort(key=lambda d: -d['score'])

        T, R = len(IOU_THRS), len(REC_THRS)
        A, M, K = len(AREA_RNGS), len(MAX_DETS), len(cat_ids)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat in enumerate(cat_ids):
            per_img = []
            for img in img_ids:
                dts = by_img_cat.get((img, cat), [])
                gts = self._gt_for(img, cat)
                if not dts and not gts:
                    per_img.append(None)
                    continue
                ious = self._ious(dts[:max(MAX_DETS)], gts)
                per_img.append((dts, gts, ious))
            for ai, (aname, arng) in enumerate(AREA_RNGS.items()):
                for mi, max_det in enumerate(MAX_DETS):
                    tps, igs, scs, npig = [], [], [], 0
                    for item in per_img:
                        if item is None:
                            continue
                        dts, gts, ious = item
                        tp, ig, sc, n_ok = self._evaluate_img(
                            dts, gts, ious, arng, max_det)
                        tps.append(tp)
                        igs.append(ig)
                        scs.append(sc)
                        npig += n_ok
                    if npig == 0:
                        continue
                    if scs and sum(len(s) for s in scs):
                        scores = np.concatenate(scs)
                        order = np.argsort(-scores, kind='mergesort')
                        tp = np.concatenate(tps, axis=1)[:, order]
                        ig = np.concatenate(igs, axis=1)[:, order]
                    else:
                        tp = np.zeros((T, 0), bool)
                        ig = np.zeros((T, 0), bool)
                    tps_c = np.cumsum(tp & ~ig, axis=1, dtype=np.float64)
                    fps_c = np.cumsum(~tp & ~ig, axis=1, dtype=np.float64)
                    for ti in range(T):
                        tp_c, fp_c = tps_c[ti], fps_c[ti]
                        rc = tp_c / npig
                        pr = tp_c / np.maximum(tp_c + fp_c, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone precision envelope
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side='left')
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[:, :, ki, ai, mi][ti] = q

        self.precision, self.recall = precision, recall
        stats = self._summarize(verbose)
        self.stats = stats
        return stats

    def _summarize(self, verbose):
        def ap(iou=None, area='all', max_det=100):
            ai = list(AREA_RNGS).index(area)
            mi = MAX_DETS.index(max_det)
            p = self.precision[:, :, :, ai, mi]
            if iou is not None:
                p = p[[np.where(np.isclose(IOU_THRS, iou))[0][0]]]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def ar(area='all', max_det=100):
            ai = list(AREA_RNGS).index(area)
            mi = MAX_DETS.index(max_det)
            r = self.recall[:, :, ai, mi]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        stats = np.array([
            ap(), ap(iou=0.5), ap(iou=0.75),
            ap(area='small'), ap(area='medium'), ap(area='large'),
            ar(max_det=1), ar(max_det=10), ar(max_det=100),
            ar(area='small'), ar(area='medium'), ar(area='large')])
        if verbose:
            names = ['AP@[.50:.95]', 'AP@.50', 'AP@.75', 'AP small',
                     'AP medium', 'AP large', 'AR max=1', 'AR max=10',
                     'AR max=100', 'AR small', 'AR medium', 'AR large']
            for n, s in zip(names, stats):
                print(f' {n:<14} = {s:.3f}')
        return stats
