"""idle_unnamed_pct: the share of the traced window's idle time (its gaps,
where no device event runs) whose gap's midpoint lies under none of the
program's spans (a host range whose name starts with ``dtpu``): the idle
time that the program's own spans cannot name."""

from gpubench import spans as S


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    named = S.union(S.named(tr, lambda n: n.startswith(S.PREFIX)))
    if not named:
        return None
    gaps = tr.gaps()
    idle = S.measure(gaps)
    if not idle:
        return 0.0
    return 100 * S.measure([(a, b) for a, b in gaps
                            if not S.covers(named, (a + b) / 2)]) / idle
