"""Row 2 (`csrc/stem_pool.cu`, the primal forward) on each traced
request's conv1 output: its least time (`lib/counts.py:stem_forward_s`)
over its device time."""

from perfbench.lib import counts
from perfbench.lib.readers import roofline


def read(ctx):
    if ctx.kind != 'serve':
        return None
    bound = ctx.steps * counts.stem_forward_s(ctx.conv1_shape, ctx.itemsize)
    return roofline(ctx, 'serve', bound, 'stem_pool')
