"""wide_keys_calls_per_query (calls): calls of the wide engine's CUDA
key-word kernels (`engine/csrc/wide_keys.cu`; `engine/psort.py`
LAUNCHES["wide_keys"], one launch a call: pack, bound, decode) in the
window, per completed query. A program without the kernels counts
nothing, and the metric is left out."""


def read(ctx):
    n = ctx.launches.get("wide_keys", 0)
    return n / len(ctx.queries) if n else None
