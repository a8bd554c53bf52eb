"""Row 1 (`csrc/nms.cu`, `csrc/nms_scan.cuh`): each traced request's
NMS least time (`lib/counts.py:nms_s`, as many rounds as its fullest
image kept) over the NMS kernels' device time."""

from perfbench.lib import counts
from perfbench.lib.readers import roofline
from perfbench.lib.trace import FAMILIES


def read(ctx):
    if ctx.kind != 'serve':
        return None
    bound = sum(counts.nms_s(ctx.batch, ctx.candidates, r, ctx.detections)
                for r in ctx.rounds)
    return roofline(ctx, 'serve', bound, *dict(FAMILIES)['nms kernel'])
