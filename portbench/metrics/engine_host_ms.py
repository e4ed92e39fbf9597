"""engine_host_ms (ms): host time of the engine layer per completed
query of the traced window: the time in the program's `plan`, `plan:
build` and `engine:` spans less the `sync:` and `gather` spans below
them, the plan lookups and the launches of kernels; see
`portbench/spans.py`."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.per_query_ms(s.engine_host_ns)
