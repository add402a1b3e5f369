"""dense_roofline: the dense updates' share of their roofline. The
benchmark's own bound of a step (roofline/<config>.json: each user field
the equations read, read once, each written field written once, over
3.35 TB/s; or its operations over 67 TFLOP/s, whichever is larger) over
the device milliseconds a step of every traced event outside the sparse
categories (scatter, gather)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.bound is None or not ctx.traced_steps:
        return None
    secs = tr.seconds(exclude=('scatter', 'gather'))
    if not secs:
        return None
    return 100 * ctx.bound[0] / (1e3 * secs / ctx.traced_steps)
