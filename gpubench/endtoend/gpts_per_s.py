"""gpts_per_s: grid points updated a second over the whole window (Devito's
GPts/s): the computed points, absorbing layer included, times the time
steps of every job that ran in the window, over the window's seconds."""


def read(ctx):
    steps = sum(j['steps'] for j in ctx.jobs if j['loop'] is not None)
    if not steps:
        return None
    return ctx.points * steps / ctx.window_s / 1e9
