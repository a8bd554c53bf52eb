"""Device ms a step in elementwise kernels (batch-norm affine,
ReLU, residual adds, bias, copies, reductions: what the families table
leaves), from the trace."""

from perfbench.lib.readers import family_ms


def read(ctx):
    return family_ms(ctx, 'train', 'elementwise')
