"""db-benchmark G1 (h2oai groupby) made on a device from a seed.

A copy of `rayforce_tpu_torch/tools/g1.py` `g1_table`'s draws with the
seed taken from the run, the sizes and ranges from the configuration,
and plain tensors out (the harness places them in the program):
integer columns uniform in [lo, hi), f64 columns uniform in [lo, hi)
rounded to `spec[4]` decimals. One torch.Generator on the device, one
call a column, in the configuration's column order.
"""
from __future__ import annotations

import torch


def make(config, seed, device):
    """{table name: {column name: tensor}} for the configuration."""
    rows = int(config["rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    tables = {}
    for tname, specs in config["tables"].items():
        cols = {}
        for spec in specs:
            name, kind, lo, hi = spec[:4]
            if kind == "int":
                cols[name] = torch.randint(int(lo), int(hi), (rows,),
                                           generator=gen, device=device,
                                           dtype=torch.int64)
            elif kind == "f64":
                v = torch.rand(rows, generator=gen, device=device,
                               dtype=torch.float64) * (hi - lo) + lo
                scale = 10.0 ** int(spec[4])
                cols[name] = torch.round(v * scale) / scale
            else:
                raise ValueError(f"g1: column {name}: kind {kind!r}")
        tables[tname] = cols
    return tables
