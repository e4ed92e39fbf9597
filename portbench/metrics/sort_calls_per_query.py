"""sort_calls_per_query (calls): calls of the CUDA radix sort
(`engine/psort.py` LAUNCHES["radix_sort"]) in the window, per completed
query."""


def read(ctx):
    n = ctx.launches.get("radix_sort", 0)
    return n / len(ctx.queries) if n else None
