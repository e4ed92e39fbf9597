"""shard_reduce_calls_per_query (calls): stage A calls of the mesh's
distributed wide group-by that totalled a scanned lane by the reduce and
carry kernels (`engine/csrc/shard_partials.cu`, entered through
`parallel/dist.py` shard_reduce; `engine/psort.py`
LAUNCHES["shard_reduce"], one count a shard a stage A with a summed,
min or max lane) in the window, per completed query. Its ratio to
shard_partials_calls_per_query is the share of stage A calls that took
that path. A program without the counter counts nothing, and the metric
is left out."""


def read(ctx):
    n = ctx.launches.get("shard_reduce", 0)
    return n / len(ctx.queries) if n else None
