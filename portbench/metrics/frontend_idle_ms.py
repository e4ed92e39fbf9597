"""frontend_idle_ms (ms): device idle inside the program's `query`
spans and the `gather` spans the harness's forcing opens, outside
`plan`, `engine:` and `sync:` spans, per completed query of the traced
window: the parse, the spec, the result's wrapping and its lazy columns;
see `portbench/spans.py`."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.per_query_ms(s.frontend_idle_ns)
