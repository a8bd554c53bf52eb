"""Device ms a step in cuDNN's layout transforms (NCHW <-> NHWC
around the convolutions), from the trace."""

from perfbench.lib.readers import family_ms


def read(ctx):
    return family_ms(ctx, 'train', 'conv layout transform')
