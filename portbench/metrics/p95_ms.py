"""p95_ms (ms): the 95th percentile of the latency, submit to sync, of
all queries completed in the window."""
from portbench.stats import percentile


def read(ctx):
    return percentile(ctx.latencies_s, 95) * 1e3
