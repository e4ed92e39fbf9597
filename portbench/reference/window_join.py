"""Plain reference of `(window-join1 [k1 ... kn time] (map-left + [a b]
(at left 'time)) left right {name: (op col) ...})`.

Each left row's window is the right rows whose leading keys equal its
own and whose time lies in [time + a, time + b], both ends inclusive.
The result has every left column as it is, then per aggregate `min` or
`max` of the right column over the window: exact, and the typed null
(NaN for f64, the least i64 for integers) where the window is empty.
A float column is taken in `fdtype`. Ranges are answered from a sparse
table over the right rows sorted by (keys, time).
"""
from __future__ import annotations

import math

import torch

from .common import NULL_I64, joint_codes, sorted_by_code_time

I64 = torch.int64


def windows(left, right, keys, lo_off, hi_off):
    """(order, first, last): the right rows sorted by (code, time), and
    per left row the first and last sorted position in its window (last
    < first where the window is empty)."""
    *lead, tkey = keys
    lt, rt = left[tkey].to(I64), right[tkey].to(I64)
    if lead:
        lc, rc, _n = joint_codes([left[k] for k in lead],
                                 [right[k] for k in lead])
    else:
        lc, rc = torch.zeros_like(lt), torch.zeros_like(rt)
    lo, hi = lt + lo_off, lt + hi_off
    t0 = int(min(rt.min(), lo.min()))
    span = int(max(rt.max(), hi.max())) - t0 + 1
    if (int(max(lc.max(), rc.max())) + 1) * span >= 1 << 62:
        raise ValueError("window reference: codes x times overflow i64")
    order = sorted_by_code_time(rc, rt)
    rkey = rc[order] * span + (rt[order] - t0)
    first = torch.searchsorted(rkey, lc * span + (lo - t0))
    last = torch.searchsorted(rkey, lc * span + (hi - t0), right=True) - 1
    return order, first, last


def range_extreme(vals, first, last, op):
    """op (min or max) of vals over [first, last] per row, for rows with
    last >= first: the two overlapping power-of-two blocks of a sparse
    table."""
    fn = torch.minimum if op == "min" else torch.maximum
    ok = last >= first
    width = torch.where(ok, last - first + 1, 1)
    levels = max(int(width.max()).bit_length(), 1)
    n = int(vals.shape[0])
    table = vals.new_empty((levels, n))
    table[0] = vals
    for k in range(1, levels):
        h = 1 << (k - 1)
        table[k] = table[k - 1]
        if h < n:
            table[k, :n - h] = fn(table[k - 1, :n - h], table[k - 1, h:])
    # k = floor(log2(width)): frexp gives width = m * 2^e with m in [0.5, 1)
    k = torch.frexp(width.to(torch.float64)).exponent.to(I64) - 1
    a = first.clamp(0, max(n - 1, 0))
    b = (last - (1 << k) + 1).clamp(0, max(n - 1, 0))
    return fn(table[k, a], table[k, b]), ok


def run(tables, spec, fdtype=torch.float64):
    if spec.get("prevailing", False):
        raise ValueError("window reference: only window-join1's windows")
    left, right = tables[spec["left"]], tables[spec["right"]]
    lo_off, hi_off = spec["window"]
    order, first, last = windows(left, right, spec["keys"], lo_off, hi_off)
    out = [(name, col, "exact") for name, col in left.items()]
    for name, op, cname in spec["aggs"]:
        if op not in ("min", "max"):
            raise ValueError(f"window reference: no aggregate {op!r}")
        col = right[cname]
        is_float = col.dtype.is_floating_point
        vals = (col.to(fdtype) if is_float else col)[order]
        got, ok = range_extreme(vals, first, last, op)
        null = math.nan if is_float else NULL_I64
        out.append((name, torch.where(ok, got, null).to(col.dtype),
                    "exact"))
    return out
