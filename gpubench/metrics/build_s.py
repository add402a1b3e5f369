"""build_s: seconds of the solver's first ``op_fwd`` call, which lowers and
plans the forward Operator, and of making the zeroing Operator (the
benchmark's own span around them in set-up)."""


def read(ctx):
    return ctx.build_s
