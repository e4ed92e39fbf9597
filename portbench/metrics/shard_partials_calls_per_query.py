"""shard_partials_calls_per_query (calls): calls of the mesh's stage A
kernels (`engine/csrc/shard_partials.cu`, entered through
`parallel/dist.py` shard_partials_cuda; `engine/psort.py`
LAUNCHES["shard_partials"], one count a shard a stage A of the
distributed wide group-by) in the window, per completed query. A program
without the kernels counts nothing, and the metric is left out."""


def read(ctx):
    n = ctx.launches.get("shard_partials", 0)
    return n / len(ctx.queries) if n else None
