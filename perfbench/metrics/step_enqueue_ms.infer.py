"""Mean host ms of one `Model.inference_fn_u8` call, from the request's
submission (the copy of its images included) to the call's return, in
the traced window."""

from perfbench.lib.readers import enqueue_ms


def read(ctx):
    return enqueue_ms(ctx, 'serve')
