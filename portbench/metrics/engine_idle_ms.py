"""engine_idle_ms (ms): device idle inside the program's `plan` and
`engine:` spans and outside the `sync:` spans below them, per completed
query of the traced window: the card starved while the engine launched
work; see `portbench/spans.py`."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.per_query_ms(s.engine_idle_ns)
