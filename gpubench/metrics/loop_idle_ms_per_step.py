"""loop_idle_ms_per_step: device-idle milliseconds a traced step inside the
time loop: the window's idle gaps (no device event runs) that lie under the
program's ``dtpu::apply.loop`` spans, over the traced steps. The part of
the loop where the host kept the card waiting."""

from gpubench import spans as S


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.traced_steps:
        return None
    loop = S.union(S.named(tr, 'dtpu::apply.loop'))
    if not loop:
        return None
    return S.measure(S.intersect(loop, tr.gaps())) * 1e-3 / ctx.traced_steps
