"""sortagg_keys_calls_per_query (calls): launches of the sort-agg
engine's CUDA main-sort word kernels (`engine/csrc/sortagg_keys.cu`;
`engine/psort.py` LAUNCHES["sortagg_keys"]: a pack and a read a sort-agg
answer, one more for each share of operands or lanes past one launch's
parameters, twice that for a straggler's first run) in the window, per
completed query. A program without the kernels counts nothing, and the
metric is left out."""


def read(ctx):
    n = ctx.launches.get("sortagg_keys", 0)
    return n / len(ctx.queries) if n else None
