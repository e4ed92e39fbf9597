"""setup_s (s): process start to the first timed query: imports, the
kernels built or loaded, the tables made and placed, the mix warmed."""


def read(ctx):
    return ctx.setup_s
