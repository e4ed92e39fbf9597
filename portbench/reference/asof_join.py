"""Plain reference of `(asof-join [k1 ... kn time] left right)`.

Each left row takes the LAST right row (in the right table's row order)
whose leading keys equal its own and whose time is at or before its
time. The result has the key columns and the other left columns as
they are; a column that both tables have takes the right value where a
row matched and the left value elsewhere; a column only the right table
has is (values, matched): the matched right row's value, and a null
where none matched. All columns are exact; a float column is carried in
`fdtype`.
"""
from __future__ import annotations

import torch

from .common import joint_codes, sorted_by_code_time


def match_rows(left, right, keys):
    """Per left row the matched right row (clamped to 0 where none) and
    whether it matched."""
    *lead, tkey = keys
    lt, rt = left[tkey].to(torch.int64), right[tkey].to(torch.int64)
    if lead:
        lc, rc, _n = joint_codes([left[k] for k in lead],
                                 [right[k] for k in lead])
    else:
        lc, rc = torch.zeros_like(lt), torch.zeros_like(rt)
    t0 = int(min(lt.min(), rt.min()))
    span = int(max(lt.max(), rt.max())) - t0 + 1
    if (int(max(lc.max(), rc.max())) + 1) * span >= 1 << 62:
        raise ValueError("asof reference: codes x times overflow i64")
    order = sorted_by_code_time(rc, rt)
    rkey = rc[order] * span + (rt[order] - t0)
    pos = torch.searchsorted(rkey, lc * span + (lt - t0), right=True) - 1
    at = pos.clamp(min=0)
    hit = (pos >= 0) & (rc[order][at] == lc)
    return order[at], hit


def run(tables, spec, fdtype=torch.float64):
    left, right = tables[spec["left"]], tables[spec["right"]]
    keys = spec["keys"]
    rid, hit = match_rows(left, right, keys)

    def carried(x):
        return x.to(fdtype).to(x.dtype) if x.dtype.is_floating_point else x
    out = [(k, left[k], "exact") for k in keys]
    for name, col in left.items():
        if name in keys:
            continue
        if name in right:
            col = torch.where(hit, carried(right[name])[rid], col)
        out.append((name, col, "exact"))
    for name, col in right.items():
        if name not in keys and name not in left:
            out.append((name, (carried(col)[rid], hit), "exact"))
    return out
