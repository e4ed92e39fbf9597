"""card_busy_max_ms (ms): the busiest card's busy time in the traced
window (the union of its kernels, copies and memsets, `trace.py`
`busy_s_per_card`) per completed query: on a mesh the card that every
other waits for at each collective."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s_per_card:
        return None
    busiest = max(ctx.trace.busy_s_per_card)
    return busiest * 1e3 / len(ctx.queries) if busiest > 0 else None
