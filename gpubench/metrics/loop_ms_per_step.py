"""loop_ms_per_step: the time loop's milliseconds a step, from the loop
seconds (CUDA events around the executor's loop) of the PerformanceSummary
that forward returns, over the window's untraced jobs."""


def read(ctx):
    jobs = [j for j in ctx.jobs if j['loop'] is not None]
    plain = [j for j in jobs if not j['traced']] or jobs
    steps = sum(j['steps'] for j in plain)
    if not steps:
        return None
    return 1e3 * sum(j['loop'] for j in plain) / steps
