"""Mean host ms of one call of the train step (`make_train_step`) in
the traced window: the benchmark's own span around the call."""

from perfbench.lib.readers import enqueue_ms


def read(ctx):
    return enqueue_ms(ctx, 'train')
