"""setup_s: seconds from the process's start to the window's start:
imports, the inputs and the model, the lowering, the kernels (built or
loaded), the self-test and the warm-up."""


def read(ctx):
    return ctx.setup_s
