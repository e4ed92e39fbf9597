"""host_syncs_per_query (syncs): the program's reads that wait for the
device (its `sync:` spans, `core/profiler.py`), per completed query of
the traced window; see `portbench/spans.py`."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.syncs / s.queries
