"""device_busy_ms (ms): device time in the traced window (the union of
kernels, copies and memsets, torch.profiler) per completed query."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.busy_s * 1e3 / len(ctx.queries)
