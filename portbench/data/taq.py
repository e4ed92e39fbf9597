"""The trades and quotes of RayforceDB's join examples, made on a device.

Each table of the configuration is `rows_per_n * n` rows in time order:
`Sym` cycles `sym_cycle` row by row, `Ts` is `ts_start_ms +
ts_step_ms * i`, as `examples/wj.rfl` and `examples/aj.rfl` lay them
out; each value column is f64 on the configuration's tick, uniform in
its [lo, hi) from one torch.Generator on the device seeded by the run.
Keys and times do not depend on the seed, so every seed does the same
work.
"""
from __future__ import annotations

import torch


def make(config, seed, device):
    """{table name: {column name: tensor}} for the configuration."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    n = int(config["n"])
    ticks = round(1 / config["tick"])
    sym, ts = config["keys"]
    tables = {}
    for tname, spec in config["tables"].items():
        rows = n * int(spec["rows_per_n"])
        i = torch.arange(rows, device=device, dtype=torch.int64)
        cycle = torch.tensor(spec["sym_cycle"], device=device,
                             dtype=torch.int64)
        cols = {sym: cycle[i % cycle.shape[0]],
                ts: i * int(spec["ts_step_ms"]) + int(spec["ts_start_ms"])}
        del i
        for name, (lo, hi) in spec["values"].items():
            cols[name] = torch.randint(lo * ticks, hi * ticks, (rows,),
                                       generator=gen, device=device,
                                       dtype=torch.int64).double() / ticks
        tables[tname] = cols
    return tables
