"""sparse_ms_per_step: device milliseconds a step of the traced jobs'
events in the scatter and gather categories (the source injection's
index_put_, the receivers' corner gathers)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_steps:
        return None
    secs = tr.seconds(('scatter', 'gather'))
    return 1e3 * secs / ctx.traced_steps if secs else None
