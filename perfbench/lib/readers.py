"""Helpers shared by the per-layer readers in ``perfbench/metrics/``.

A reader gets the traced run's context (``lib/cell.py:_context``): the
window's trace (``lib/trace.py:Trace``), the loop's kind (``train`` or
``serve``), the steps or requests in the window and the cell's shapes.
It returns ``None`` where it finds nothing to read.
"""

from perfbench.lib import counts


def family_ms(ctx, kind, fam):
    """Device ms a step (or request) in one kernel family."""
    if ctx.kind != kind or not ctx.steps:
        return None
    seconds = ctx.trace.family_s().get(fam, 0.0)
    return 1e3 * seconds / ctx.steps if seconds else None


def roofline(ctx, kind, bound_s, *fragments):
    """100 x the kernels' least time over their device time, the kernels
    named by any of ``fragments``."""
    if ctx.kind != kind or not ctx.steps:
        return None
    seconds = ctx.trace.matching_s(*fragments)
    return 100.0 * bound_s / seconds if seconds else None


def mfu(ctx, kind):
    """The window's model FLOPs (2 x convolution multiply-adds, x 3 for a
    train step) over the window's time at the card's bf16 peak, in %."""
    if ctx.kind != kind or not ctx.steps:
        return None
    per_image = 2 * ctx.image_macs * (3 if kind == 'train' else 1)
    flops = per_image * ctx.batch * ctx.steps
    return 100.0 * flops / (ctx.trace.window_s * counts.PEAK['bf16_flops'])


def idle_share(ctx, kind):
    if ctx.kind != kind:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def enqueue_ms(ctx, kind):
    if ctx.kind != kind or not ctx.enqueue_ms:
        return None
    return sum(ctx.enqueue_ms) / len(ctx.enqueue_ms)
