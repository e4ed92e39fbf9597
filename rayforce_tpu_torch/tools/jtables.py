"""The join and table-sort benchmark tables of bench.py, made on a device
from a seeded torch.Generator with bench.py's column specs:

- `t`: the db-benchmark G1 table (tools/g1.py);
- `r` (bench.py:439-446): the right table of the ij and lj joins, rows/10
  rows: `id3` a random half of 0 .. 2*rows/10 - 1 (every value distinct,
  so about half of them fall in G1's id3 range [0, rows/100)), `w1` f64
  uniform in [0, 100);
- `trades` and `quotes` (bench.py:468-475): rows and 2*rows rows, `sym`
  i64 uniform in [0, 18000), `ts` i64 uniform in [0, 2e9) and sorted,
  `quotes.p` f64 uniform in [10, 200) rounded to 1e-6;
- `quotesn`: `quotes`' own `sym` and `ts` tensors with two nullable
  columns for the window joins: `pn`, `p` with a seeded 1% set to null
  (NaN), and `qn`, round(p * 100) as i64 with a seeded 1% set to
  NULL_I64.

At rows = 1e7 these are the bench's own sizes: ij and lj join 1e7 rows
to 1e6, aj 1e7 trades to 2e7 quotes.
"""
from __future__ import annotations

import torch

from ..core import types as T
from ..core.obj import DevPending, Obj, table, vec_sym
from ..engine import device as dev
from .g1 import g1_table

# each join and table sort over the tables, with the engine it must run
JOIN_QUERIES = {
    "ij": ("(inner-join [id3] t r)", "device-sortmerge"),
    "lj": ("(left-join [id3] t r)", "device-sortmerge"),
    "aj": ("(asof-join [sym ts] trades quotes)", "device-sortmerge"),
    # the reference's multi-chip bench sort shape (bench.py:245)
    "xasc": ("(xasc t [id3 v1])", "device-sort"),
    "xdesc": ("(xdesc t 'v3)", "device-sort"),
}

# the window joins over trades and quotes (engine device-wjoin): wj is
# bench.py's own query (bench.py:478-481; windows of about 0.001 quotes,
# so nearly every result is a typed null), wj0 prevailing windows of
# about 12 quotes with every aggregate, nulls on both routes
WJOIN_QUERIES = {
    "wj": "(window-join1 [sym ts] (map-left + [-1000 1000] (at trades 'ts)) "
          "trades quotes {mx: (max p) mn: (min p)})",
    "wj0": "(window-join [sym ts] (map-left + [-10000000 10000000] "
           "(at trades 'ts)) trades quotesn {c: (count pn) s: (sum pn) "
           "a: (avg pn) d: (dev pn) f: (first pn) l: (last qn) "
           "mn: (min qn) mx: (max pn)})",
}


def force_columns(tbl):
    """Every column of a join or sort result as device tensors, each lazy
    column forced (a timing must include the gathers): a typed column
    gives (tensor,), a right-only LIST column its (values, match mask);
    a column passed through unchanged gives its own device copy."""
    out = []
    for c in tbl.v[1]:
        p = c.pending()
        a = p.arr if p is not None else dev.dev_col(c)
        out.append(tuple(a) if c.t == T.LIST else (a,))
    return out


def _table(names, arrays):
    cols = []
    for a in arrays:
        c = Obj(T.F64 if a.dtype == torch.float64 else T.I64, DevPending(a))
        c.meta = {"dev": a}
        cols.append(c)
    t = table(vec_sym(names), cols)
    dev.put_table(t)
    return t


def join_tables(rows, device):
    """{name: table} of t, r, trades, quotes and quotesn at `rows` G1
    rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    nr = rows // 10
    id3 = torch.randperm(2 * nr, generator=gen, device=device)[:nr]
    w1 = torch.rand(nr, generator=gen, device=device,
                    dtype=torch.float64) * 100.0
    out = {"t": g1_table(rows, device), "r": _table(["id3", "w1"],
                                                      [id3, w1])}
    for name, n in (("trades", rows), ("quotes", 2 * rows)):
        sym = torch.randint(0, 18_000, (n,), generator=gen, device=device,
                            dtype=torch.int64)
        # set-up only: sorted times, as bench.py's "sorted_int" column
        ts = torch.randint(0, 2_000_000_000, (n,), generator=gen,
                           device=device, dtype=torch.int64).sort().values
        names, arrays = ["sym", "ts"], [sym, ts]
        if name == "quotes":
            p = torch.rand(n, generator=gen, device=device,
                           dtype=torch.float64) * 190.0 + 10.0
            names.append("p")
            arrays.append(torch.round(p * 1e6) / 1e6)
        out[name] = _table(names, arrays)
    sym, ts, p = (out["quotes"].v[1][i].pending().arr for i in range(3))
    n = int(p.shape[0])
    pn = torch.where(torch.rand(n, generator=gen, device=device) < 0.01,
                     float("nan"), p)
    qn = torch.where(torch.rand(n, generator=gen, device=device) < 0.01,
                     int(T.NULL_I64), torch.round(p * 100).to(torch.int64))
    out["quotesn"] = _table(["sym", "ts", "pn", "qn"], [sym, ts, pn, qn])
    return out
