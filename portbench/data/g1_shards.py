"""db-benchmark G1 (h2oai groupby) made shard by shard, one card a shard.

The draws of `data/g1.py` (integer columns uniform in [lo, hi), f64
columns uniform in [lo, hi) rounded to `spec[4]` decimals, one call a
column in the configuration's column order), made for each row block
apart: block i by a torch.Generator of its own on devices[i], seeded
from (seed, i), so that no card ever holds a whole column. The
configuration's `rows` split into `chips` equal blocks.
"""
from __future__ import annotations

import hashlib

import torch


def _seed(seed, shard):
    """A 64-bit seed of the shard's generator from (seed, shard)."""
    digest = hashlib.blake2b(f"g1_shards:{int(seed)}:{shard}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def make_shards(config, seed, devices):
    """{table name: {column name: [one tensor a device]}}: row block i of
    every column on devices[i], rows / len(devices) rows a block."""
    n = len(devices)
    rows = int(config["rows"])
    if rows % n:
        raise ValueError(f"g1_shards: {rows} rows do not split into {n} "
                         f"equal shards")
    per = rows // n
    tables = {tname: {spec[0]: [None] * n for spec in specs}
              for tname, specs in config["tables"].items()}
    for i, device in enumerate(devices):
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed(seed, i))
        for tname, specs in config["tables"].items():
            for spec in specs:
                name, kind, lo, hi = spec[:4]
                if kind == "int":
                    x = torch.randint(int(lo), int(hi), (per,),
                                      generator=gen, device=device,
                                      dtype=torch.int64)
                elif kind == "f64":
                    v = torch.rand(per, generator=gen, device=device,
                                   dtype=torch.float64) * (hi - lo) + lo
                    scale = 10.0 ** int(spec[4])
                    x = torch.round(v * scale) / scale
                else:
                    raise ValueError(f"g1_shards: column {name}: kind "
                                     f"{kind!r}")
                tables[tname][name][i] = x
    return tables


def make(config, seed, device):
    """The same tables whole on `device`: the concatenation of the
    configuration's `chips` shards."""
    n = int(config.get("chips", 1))
    shards = make_shards(config, seed, [torch.device(device)] * n)
    return {tname: {name: torch.cat(xs) for name, xs in cols.items()}
            for tname, cols in shards.items()}
