"""Row 5 (`csrc/det_loss.cu`), forward and backward: the least time
of each traced step's call (`lib/counts.py:det_loss_s`, box tensors at
that batch's foreground anchors) over the kernels' device time."""

from perfbench.lib import counts
from perfbench.lib.readers import roofline


def read(ctx):
    if ctx.kind != 'train':
        return None
    bound = sum(counts.det_loss_s(ctx.logits, ctx.anchors, fg, 4, ctx.levels,
                                  ctx.itemsize) for fg in ctx.fg_anchors)
    return roofline(ctx, 'train', bound, 'det_loss')
