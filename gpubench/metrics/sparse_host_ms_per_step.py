"""sparse_host_ms_per_step: host milliseconds a traced step in the sparse
ops: the union of the program's ``dtpu::sparse.inject`` and
``dtpu::sparse.interp`` spans, less the CUDA runtime and driver calls inside
them, over the traced steps."""

from gpubench import spans as S


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_steps:
        return None
    sparse = S.union(S.named(tr, lambda n: n.startswith('dtpu::sparse.')))
    if not sparse:
        return None
    host = S.measure(sparse) - S.measure(S.intersect(sparse, S.runtime(tr)))
    return host * 1e-3 / ctx.traced_steps
