"""frontend_ms (ms): the mean host time of the query front end per
select, from the program's own span "select: eval spec"
(`core/profiler.py`, reset before each query): the parse and the
evaluation of the select's spec before any engine runs."""

SPAN = "select: eval spec"


def read(ctx):
    ms = ctx.spans.get(SPAN)
    return sum(ms) / len(ms) if ms else None
