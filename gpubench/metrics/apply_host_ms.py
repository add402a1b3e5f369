"""apply_host_ms: host milliseconds a traced job spends in the solver's and
Operator.apply's own work: the union of the program's ``dtpu::solver.*``
and ``dtpu::apply`` spans, less their ``dtpu::apply.loop`` children (the
time loop) and less the CUDA runtime and driver calls inside them (the
closing synchronize waits for the device; it is not host work), over the
traced jobs."""

from gpubench import spans as S


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.jobs:
        return None
    outer = S.union(S.named(tr, lambda n: n == 'dtpu::apply' or
                            n.startswith('dtpu::solver.')))
    if not outer:
        return None
    other = S.union(S.named(tr, 'dtpu::apply.loop') + S.runtime(tr))
    host = S.measure(outer) - S.measure(S.intersect(outer, other))
    return host * 1e-3 / tr.jobs
