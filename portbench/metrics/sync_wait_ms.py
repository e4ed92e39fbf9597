"""sync_wait_ms (ms): the host's time blocked on the device, inside the
program's `sync:` spans, per completed query of the traced window; see
`portbench/spans.py`."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.per_query_ms(s.sync_ns)
