"""k1_launch_host_us: mean host microseconds of one K1 launch: the
program's ``dtpu::k1.launch`` spans (one a launch, from the rows' checks to
the kernel's return), less the CUDA runtime and driver calls inside them,
over the number of spans in the traced window."""

from gpubench import spans as S


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    launches = S.named(tr, 'dtpu::k1.launch')
    if not launches:
        return None
    k1 = S.union(launches)
    host = S.measure(k1) - S.measure(S.intersect(k1, S.runtime(tr)))
    return host / len(launches)
