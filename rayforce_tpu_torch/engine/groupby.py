"""Group-by kernels over sorted segments, in plain torch.

This slice ports what the sort-agg engine (engine/sortagg.py) needs:
the sentinels and the inclusive segmented min/max/sum scan over runs of
equal segment ids. The small-code-space kernels of the TPU package's
groupby.py (bcast_scan, matmul_tasks_scan, Packer/unpack) come with the
<=512-code select pipeline (ROADMAP).
"""
from __future__ import annotations

import torch

SMALL_N = 512

I64_MIN = -0x8000000000000000
KEY_MAX = 0x7FFFFFFFFFFFFFFF

_SEG_B = 1024   # intra-block width for the two-level segmented scan

_IDENT = {
    torch.float64: {"min": float("inf"), "max": float("-inf"), "sum": 0.0},
    torch.int32: {"min": 0x7FFFFFFF, "max": -0x80000000, "sum": 0},
    torch.int64: {"min": KEY_MAX, "max": I64_MIN, "sum": 0},
}


def _identity_for(vals, op):
    return _IDENT[vals.dtype][op]


def _apply(op, a, b):
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    return a + b


def _seg_scan(seg_ids, vals, op):
    """Inclusive segmented scan over runs of equal seg_ids (sorted
    ascending). Two-level log doubling: log2(B) shift+op steps inside
    1024-wide blocks, then a block-summary scan and one combine pass —
    the same blocking as the TPU package's scan, so sums add in the
    same order."""
    ident = _identity_for(vals, op)
    n = vals.shape[0]
    R = -(-n // _SEG_B)
    pad = R * _SEG_B - n
    s2 = torch.cat([seg_ids, seg_ids.new_full((pad,), -2)]) \
        .reshape(R, _SEG_B)
    m = torch.cat([vals, vals.new_full((pad,), ident)]).reshape(R, _SEG_B)

    d = 1
    while d < _SEG_B:
        same = s2[:, d:] == s2[:, :-d]
        shifted = torch.where(same, m[:, :-d], ident)
        m = torch.cat([m[:, :d], _apply(op, m[:, d:], shifted)], dim=1)
        d *= 2

    # block summaries: segmented scan over block tail values, with
    # flags = boundary inside the block OR at its left joint
    first_seg = s2[:, 0]
    carry_seg = s2[:, -1]
    cv = m[:, -1]
    internal = first_seg != carry_seg
    joint = torch.cat([torch.ones(1, dtype=torch.bool, device=vals.device),
                       first_seg[1:] != carry_seg[:-1]])
    g = internal | joint
    d = 1
    while d < R:
        ga, gb = g[:-d], g[d:]
        combined = _apply(op, cv[:-d], cv[d:])
        cv = torch.cat([cv[:d], torch.where(gb, cv[d:], combined)])
        g = torch.cat([g[:d], ga | gb])
        d *= 2
    # exclusive prefix for each block r = inclusive at r-1 when chained
    pfx = torch.cat([cv.new_full((1,), ident), cv[:-1]])
    pfx = torch.where(joint, ident, pfx)
    in_first_run = s2 == first_seg[:, None]
    m = torch.where(in_first_run, _apply(op, m, pfx[:, None]), m)
    return m.reshape(R * _SEG_B)[:n]


def seg_doubling_min(seg_ids, vals):
    return _seg_scan(seg_ids, vals, "min")


def seg_doubling_max(seg_ids, vals):
    return _seg_scan(seg_ids, vals, "max")


def seg_doubling_sum(seg_ids, vals):
    return _seg_scan(seg_ids, vals, "sum")
