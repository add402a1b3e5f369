"""k1_ms_per_step: device milliseconds a step of the traced jobs' K1
events (the stencil category: dtpu::stencil_kernel, dtpu::stream_kernel)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_steps:
        return None
    secs = tr.seconds(('stencil',))
    return 1e3 * secs / ctx.traced_steps if secs else None
