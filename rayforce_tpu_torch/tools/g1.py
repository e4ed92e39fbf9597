"""The db-benchmark G1 group-by table (h2oai db-benchmark, K=100), made
on a device from a seeded torch.Generator with bench.py's column specs.
"""
from __future__ import annotations

import torch

from ..core import types as T
from ..core.obj import DevPending, Obj, table, vec_sym
from ..engine import device as dev

NAMES = ["id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3"]


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
