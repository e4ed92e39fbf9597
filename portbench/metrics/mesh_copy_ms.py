"""mesh_copy_ms (ms): device time of the copies from one card to
another (the trace's peer-to-peer memcpy events, "Memcpy PtoP"), summed
over the cards, in the traced window per completed query. A trace with
no such copy, such as one card's or CPU torch's, reads nothing, and the
metric is left out."""

PEER = "Memcpy PtoP"


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.seconds_of(lambda name: name.startswith(PEER))
    return s * 1e3 / len(ctx.queries) if s > 0 else None
