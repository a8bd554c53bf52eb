"""100 x (1 - the union of the device's busy intervals over the traced
window's length)."""

from perfbench.lib.readers import idle_share


def read(ctx):
    return idle_share(ctx, 'train')
