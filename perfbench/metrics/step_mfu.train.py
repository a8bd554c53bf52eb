"""The whole train step's share of the card's bf16 peak (989 TFLOP/s):
2 x the convolutions' multiply-adds of the configuration at the cell's
canvas, x 3 for forward and backward, over the traced window's time."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx, 'train')
