"""apply_overhead_ms: a job's milliseconds outside its time loop, the
solver's and Operator.apply's own (argument preparation, allocation; in a
shot also the zeroing and the record's copy to the host): each job's wall
time less the loop seconds of the PerformanceSummary that forward
returns, averaged over the window's untraced jobs."""


def read(ctx):
    jobs = [j for j in ctx.jobs if j['loop'] is not None]
    plain = [j for j in jobs if not j['traced']] or jobs
    if not plain:
        return None
    return 1e3 * sum(j['wall'] - j['loop'] for j in plain) / len(plain)
