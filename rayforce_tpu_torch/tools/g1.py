"""The db-benchmark G1 group-by table (h2oai db-benchmark, K=100), made
on a device from a seeded torch.Generator with bench.py's column specs.
"""
from __future__ import annotations

import torch

from ..core import types as T
from ..core.obj import DevPending, Obj, table, vec_sym
from ..engine import device as dev

NAMES = ["id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3"]

# grouped selects over the table (bench.py q1-q7 and the other shapes
# each engine takes), with the engine each must run: "dense"
# (engine/select.py's dense plan: <= 512 codes, or no by), "sortagg" or
# "wide"
QUERIES = {
    "q1": ("(select {s: (sum v1) from: t by: id1})", "dense"),
    "q4": ("(select {a1: (avg v1) a2: (avg v2) a3: (avg v3) from: t "
           "by: id4})", "dense"),
    "med": ("(select {m: (med v3) s: (sum v2) from: t by: id4})", "dense"),
    "no_by": ("(select {s: (sum v1) a: (avg v3) mx: (max v2) mn: (min v3) "
              "from: t})", "dense"),
    "small_where": ("(select {f: (first v3) l: (last v1) c: (count v2) "
                    "from: t by: id1 where: (> v3 50.0)})", "dense"),
    "q2": ("(select {s: (sum v1) from: t by: {id1: id1 id2: id2}})",
           "sortagg"),
    "q3": ("(select {s: (sum v1) a: (avg v3) from: t by: id3})", "sortagg"),
    "q5": ("(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: t "
           "by: id6})", "sortagg"),
    "q6": ("(select {mx: (max v1) mn: (min v2) from: t by: id3})",
           "sortagg"),
    "first_last": ("(select {f: (first v3) l: (last v1) from: t by: id3})",
                   "sortagg"),
    "where": ("(select {s: (sum v1) a: (avg v3) from: t by: id3 "
              "where: (> v3 50.0)})", "sortagg"),
    "q7": ("(select {s: (sum v3) c: (count v3) from: t by: {id1: id1 "
           "id2: id2 id3: id3 id4: id4 id5: id5 id6: id6}})", "wide"),
}


# grouped selects over the table written as a date-parted database
# `pt` (chip_smoke.py's parted phase): avg streams as sum and count
# partials, dev as sum, sum of squares and count
PARTED_QUERIES = {
    "q1": "(select {s: (sum v1) from: pt by: id1})",
    "q3": "(select {s: (sum v1) a: (avg v3) from: pt by: id3})",
    "q5": "(select {s1: (sum v1) s2: (sum v2) s3: (sum v3) from: pt "
          "by: id6})",
    "q6": "(select {mx: (max v1) mn: (min v2) from: pt by: id3})",
    "dev": "(select {d: (dev v3) from: pt by: id4})",
    "where": "(select {s: (sum v1) a: (avg v3) from: pt by: id3 "
             "where: (> v3 50.0)})",
}


def g1_table(rows, device):
    """db-benchmark G1 (K=100) on `device`, with bench.py's column specs:
    id1, id2, id4, id5 in [0,100); id3, id6 in [0,100000); v1 in [1,6);
    v2 in [1,16); v3 uniform in [0,100) rounded to 1e-6."""
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    cols = []
    specs = [(0, 100), (0, 100), (0, 100_000), (0, 100), (0, 100),
             (0, 100_000), (1, 6), (1, 16)]
    for lo, hi in specs:
        a = torch.randint(lo, hi, (rows,), generator=gen, device=device,
                          dtype=torch.int64)
        cols.append(Obj(T.I64, DevPending(a)))
    v3 = torch.rand(rows, generator=gen, device=device,
                    dtype=torch.float64) * 100.0
    cols.append(Obj(T.F64, DevPending(torch.round(v3 * 1e6) / 1e6)))
    for c in cols:
        c.meta = {"dev": c.pending().arr}
    t = table(vec_sym(NAMES), cols)
    dev.put_table(t)
    return t
