"""sortagg_exact_calls_per_query (calls): grouped selects whose answer
came from the sort-agg engine's exact plan (its i64 code|position|packed
key, no head sort; `engine/sortagg.py` run, a straggler's re-run on the
exact fallback included; `engine/psort.py` LAUNCHES["sortagg_exact"],
counted on the host) in the window, per completed query. A program
without the counter counts nothing, and the metric is left out."""


def read(ctx):
    if "sortagg_exact" not in ctx.launches:
        return None
    return ctx.launches["sortagg_exact"] / len(ctx.queries)
