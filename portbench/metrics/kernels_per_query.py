"""kernels_per_query (launches): device kernels in the traced window
(torch.profiler), per completed query."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / len(ctx.queries)
