"""Rows 3 and 4 (`csrc/stem_pool.cu`): the argmax forward and the
routing backward of each traced step on the conv1 output, their least
time (`lib/counts.py:stem_train_s`) over their device time."""

from perfbench.lib import counts
from perfbench.lib.readers import roofline


def read(ctx):
    if ctx.kind != 'train':
        return None
    bound = ctx.steps * counts.stem_train_s(ctx.conv1_shape, ctx.itemsize)
    return roofline(ctx, 'train', bound, 'stem_pool')
