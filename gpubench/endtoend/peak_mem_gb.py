"""peak_mem_gb: the most device memory the program had allocated during
the window (torch.cuda.max_memory_allocated, reset as the window starts),
in 1e9 bytes."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 1e9
