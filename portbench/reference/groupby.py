"""Plain reference of a grouped select: `(select {name: (op col) ...
from: table by: keys})`.

Groups are the distinct combinations of the key columns, in the order
of their first row. The result has the key columns (each group's first
row), then one column per aggregate: `sum` (i64 over an integer column,
exact; f64 over a float one), `avg` (f64: the sum over the count),
`min`, `max` (the column's own type, exact) and `count` (i64). Sums of
f64 and averages are "float" lanes, computed in `fdtype`; the rest is
exact.
"""
from __future__ import annotations

import torch

from .common import dense_codes

I64 = torch.int64


def run(tables, spec, fdtype=torch.float64):
    cols = tables[spec["table"]]
    code, n_codes = dense_codes([cols[k] for k in spec["by"]])
    n = int(code.shape[0])
    dev = code.device
    rows = torch.arange(n, device=dev)
    first = torch.full((n_codes,), n, dtype=I64, device=dev).scatter_reduce_(
        0, code, rows, "amin")
    present = torch.nonzero(first < n).squeeze(1)
    groups = present[torch.argsort(first[present])]
    n_groups = int(groups.shape[0])
    slot = torch.empty(n_codes, dtype=I64, device=dev)
    slot[groups] = torch.arange(n_groups, device=dev)
    gid = slot[code]
    first_rows = first[groups]
    counts = torch.bincount(gid, minlength=n_groups)
    out = [(k, cols[k][first_rows], "exact") for k in spec["by"]]
    for name, op, cname in spec["aggs"]:
        v = cols[cname]
        is_float = v.dtype.is_floating_point
        if op == "count":
            out.append((name, counts, "exact"))
        elif op in ("sum", "avg"):
            acc_t = fdtype if is_float else I64
            s = torch.zeros(n_groups, dtype=acc_t, device=dev).index_add_(
                0, gid, v.to(acc_t))
            if op == "avg":
                s = s.to(fdtype) / counts.to(fdtype)
            kind = "float" if is_float or op == "avg" else "exact"
            out.append((name, s.to(torch.float64) if kind == "float" else s,
                        kind))
        elif op in ("min", "max"):
            x = v.to(fdtype) if is_float else v
            r = torch.zeros(n_groups, dtype=x.dtype, device=dev)
            r = r.scatter_reduce_(0, gid, x, "a" + op, include_self=False)
            out.append((name, r.to(v.dtype), "exact"))
        else:
            raise ValueError(f"groupby reference: no aggregate {op!r}")
    return out
