"""qps (queries/s): all queries completed in the window over the
window's seconds (first submit to last sync)."""


def read(ctx):
    return len(ctx.latencies_s) / ctx.window_s
