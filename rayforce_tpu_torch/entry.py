"""The engine's flagship step as a standalone entry point: the fused
filter + group + aggregate pipeline of the grouped select, on torch
tensors.

    from rayforce_tpu_torch.entry import entry
    step, args = entry()            # args on the card
    sums, counts, min_price, first_row = step(*args)

`entry(device="cpu")` puts the arguments on the CPU instead.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import device as dev
from .engine import groupby as G

N_GROUPS = 100


def step(keys, values, prices):
    """Where prices > 50: per key in [0, N_GROUPS), the sum of values
    and the row count (exact integer segment sums), the least price and
    the first row id (KEY_MAX for a key with no row). Masked rows go to
    the trash code N_GROUPS."""
    n = keys.shape[0]
    codes = torch.where(prices > 50.0, keys.to(torch.int32), N_GROUPS)
    s, c = G.matmul_tasks_scan(
        codes, [values, torch.ones(n, dtype=torch.int32,
                                   device=keys.device)],
        N_GROUPS + 1, n)
    bc = G.bcast_scan(codes, N_GROUPS, n, mins=(prices.to(torch.float64),),
                      want_counts=False, want_fidx=True)
    return s[:N_GROUPS], c[:N_GROUPS], bc["min0"], bc["fidx"]


def entry(device=None):
    """(step, args): args are 4096 seeded rows (keys i32 in [0, 100),
    values i32 in [0, 100), prices f32 in [0, 100)) on `device` (the
    engine's device when None)."""
    d = torch.device(device) if device is not None else dev.device()
    n = 4096
    rng = np.random.default_rng(0)
    args = (rng.integers(0, N_GROUPS, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int32),
            rng.uniform(0, 100, n).astype(np.float32))
    return step, tuple(torch.from_numpy(a).to(d) for a in args)
