"""idle_pct: the share of the traced window (the first traced job's start
to the last one's end) that no device event covers: 100 (1 - the union of
the device events' intervals over the window's length)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.window_s:
        return None
    return 100 * (1 - tr.busy_s / tr.window_s)
