"""A kernel family's share of its byte roofline in a traced window.

share = sum over the family's calls of (bytes the call needs / HBM
bandwidth) / the family's device time in the trace, in %. On a cell of
several cards the bytes are summed over the calls on every card and the
device time over every card's kernels, so the share is against one
card's bandwidth for each card at work. Each roofline
metric's file names the family: `ENTRY`, the program's entry point whose
calls the harness records in the traced run (module, attribute);
`call_bytes`, with the entry's signature, the bytes one call needs (each
input read once, each output written once: no arithmetic to speak of
bounds these kernels); `KERNELS`, the pattern of the family's kernel
names in the trace.
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB: 3.35 TB/s of HBM3 (NVIDIA's data sheet, at the
# 700 W power limit; the run prints the card's limit)
HBM_BYTES_PER_S = 3.35e12


def share(ctx, metric, kernels):
    """The roofline share in % of the calls recorded under `metric`
    against the device time of the kernels whose names match `kernels`
    (a compiled pattern); None where either is missing."""
    if ctx.trace is None:
        return None
    nbytes = sum(ctx.calls.get(metric, ()))
    seconds = ctx.trace.seconds_of(lambda name: kernels.search(name))
    if nbytes <= 0 or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
