"""Plain reference of a grouped select over a table given shard by shard:
`(select {name: (op col) ...  from: table by: keys})`, each column a
list of row blocks, block i on its own card.

The same result as `reference/groupby.py` over the blocks' concatenation
(groups in the order of their first row; the key columns, then `sum`,
`avg`, `min`, `max`, `count` as there), without a whole column on any
card: each block's partials are worked out on the block's own card (per
key, its first row, count, and each aggregate's sum, min or max), then
merged on the first block's card. A key is the mixed-radix code of the
key columns over their ranges across all blocks. Integer results are
exact; `avg` is the merged sum over the merged count; f64 sums and
averages are "float" lanes in `fdtype`.
"""
from __future__ import annotations

import torch

I64 = torch.int64
_CODE_LIMIT = 1 << 62
# the harness hands this kind a sharded table's shard lists
SHARDS = True


def _radix(blocks_by_key):
    """(lo, span) of each key column over all its blocks; raises where
    the mixed-radix code would not fit in 62 bits."""
    out, n_codes = [], 1
    for blocks in blocks_by_key:
        lo = min(int(b.min()) for b in blocks)
        span = max(int(b.max()) for b in blocks) - lo + 1
        n_codes *= span
        out.append((lo, span))
    if n_codes >= _CODE_LIMIT:
        raise ValueError("groupby_shards: the keys' code space passes 2^62")
    return out


def _partials(cols, keys, radix, aggs, offset, fdtype):
    """One block's partials on its card: (codes, first global row, key
    values, count, {agg index: partial})."""
    code = None
    for k, (lo, span) in zip(keys, radix):
        c = cols[k].to(I64) - lo
        code = c if code is None else code * span + c
    uniq, gid = torch.unique(code, return_inverse=True)
    n, ng = int(code.shape[0]), int(uniq.shape[0])
    dev = code.device
    first = torch.full((ng,), n, dtype=I64, device=dev).scatter_reduce_(
        0, gid, torch.arange(n, device=dev), "amin")
    count = torch.bincount(gid, minlength=ng)
    parts = {}
    for j, (_name, op, cname) in enumerate(aggs):
        v = cols[cname]
        if op in ("sum", "avg"):
            acc_t = fdtype if v.dtype.is_floating_point else I64
            parts[j] = torch.zeros(ng, dtype=acc_t, device=dev).index_add_(
                0, gid, v.to(acc_t))
        elif op in ("min", "max"):
            x = v.to(fdtype) if v.dtype.is_floating_point else v
            parts[j] = torch.zeros(ng, dtype=x.dtype, device=dev) \
                .scatter_reduce_(0, gid, x, "a" + op, include_self=False)
        elif op != "count":
            raise ValueError(f"groupby_shards reference: no aggregate "
                             f"{op!r}")
    return (uniq, first + offset, [cols[k][first] for k in keys], count,
            parts)


def run(tables, spec, fdtype=torch.float64):
    blocks = tables[spec["table"]]
    keys, aggs = spec["by"], spec["aggs"]
    radix = _radix([blocks[k] for k in keys])
    names = list(blocks)
    dev = blocks[names[0]][0].device
    got, offset = [], 0
    for i in range(len(blocks[names[0]])):
        cols = {name: blocks[name][i] for name in names}
        p = _partials(cols, keys, radix, aggs, offset, fdtype)
        offset += int(cols[names[0]].shape[0])
        codes, first, kvals, count, parts = p
        got.append((codes.to(dev), first.to(dev), [x.to(dev) for x in kvals],
                    count.to(dev), {j: x.to(dev) for j, x in parts.items()}))
    # merge on the first block's card
    uniq, gid = torch.unique(torch.cat([g[0] for g in got]),
                             return_inverse=True)
    ng = int(uniq.shape[0])
    first = torch.full((ng,), offset, dtype=I64, device=dev).scatter_reduce_(
        0, gid, torch.cat([g[1] for g in got]), "amin")
    order = torch.argsort(first)
    gid = torch.argsort(order)[gid]         # group ids in first-row order
    count = torch.zeros(ng, dtype=I64, device=dev).index_add_(
        0, gid, torch.cat([g[3] for g in got]))
    out = []
    for j, k in enumerate(keys):
        vals = torch.cat([g[2][j] for g in got])
        out.append((k, torch.zeros(ng, dtype=vals.dtype, device=dev)
                    .scatter_reduce_(0, gid, vals, "amin",
                                     include_self=False), "exact"))
    for j, (name, op, cname) in enumerate(aggs):
        is_float = blocks[cname][0].dtype.is_floating_point
        if op == "count":
            out.append((name, count, "exact"))
            continue
        part = torch.cat([g[4][j] for g in got])
        if op in ("sum", "avg"):
            s = torch.zeros(ng, dtype=part.dtype, device=dev).index_add_(
                0, gid, part)
            if op == "avg":
                s = s.to(fdtype) / count.to(fdtype)
            kind = "float" if is_float or op == "avg" else "exact"
            out.append((name, s.to(torch.float64) if kind == "float" else s,
                        kind))
        else:
            r = torch.zeros(ng, dtype=part.dtype, device=dev).scatter_reduce_(
                0, gid, part, "a" + op, include_self=False)
            out.append((name, r.to(blocks[cname][0].dtype), "exact"))
    return out
