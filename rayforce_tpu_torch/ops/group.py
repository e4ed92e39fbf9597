"""Group index construction (reference core/index.c index_group*).

A GroupIndex is the analogue of the reference's 7-slot index object
(index.c:1696): per-row group ids assigned in FIRST-APPEARANCE order, the
group count, and the first row id of each group (used for group-key values
and `first`).

Strategies mirror the reference tiering in spirit: small integer ranges use
a dense perfect mapping; everything else goes through a hash/unique path.
On device, the engine module replaces these with segment-sum kernels.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np
from ..core.errors import err_type


class GroupIndex:
    __slots__ = ("gids", "n", "first_ids", "source_len")

    def __init__(self, gids: np.ndarray, n: int, first_ids: np.ndarray):
        self.gids = gids
        self.n = n
        self.first_ids = first_ids
        self.source_len = len(gids)


def _first_appearance(codes: np.ndarray) -> GroupIndex:
    """Relabel arbitrary integer codes to first-appearance-ordered ids."""
    uniq, first_idx, inv = np.unique(codes, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(uniq), dtype=np.int64)
    remap[order] = np.arange(len(uniq), dtype=np.int64)
    gids = remap[inv.astype(np.int64)]
    return GroupIndex(gids, len(uniq), first_idx[order].astype(np.int64))


def _col_codes(col: Obj) -> np.ndarray:
    """Integer codes for grouping a column. f64 uses bit patterns so NaN
    groups as a single value; GUID hashes rows; parted columns (incl.
    the virtual Date, storage/parted.py) raze to flat first."""
    t = col.t
    if t in T.UNPARTED_OF:
        from .parted import parted_raze as raze_parted
        col = raze_parted(col)
        t = col.t
    if t == T.LIST:
        raise err_type("cannot group a list column")
    a = to_np(col)
    if t == T.F64:
        return a.view(np.int64)
    if t == T.GUID:
        return np.asarray(
            [hash(a[i].tobytes()) for i in range(len(a))], dtype=np.int64)
    if t == T.C8:
        raise err_type("cannot group chars")
    return a.astype(np.int64)


def group_single(col: Obj) -> GroupIndex:
    return _first_appearance(_col_codes(col))


def group_multi(cols: list) -> GroupIndex:
    """Multi-column grouping: combine per-column codes.

    Mirrors index_group_list_perfect (index.c:2308) when ranges are small
    (range-multiplier perfect mapping), else falls back to lexicographic
    np.unique over the code matrix (the radix/hash path analogue)."""
    if len(cols) == 1:
        return group_single(cols[0])
    codes = [_col_codes(c) for c in cols]
    if len(codes[0]) == 0:
        # all rows filtered away: zero groups (min/max over empty
        # codes has no identity)
        z = np.zeros(0, dtype=np.int64)
        return GroupIndex(z, 0, z.copy())
    # try perfect range multipliers
    total = 1
    combined = None
    ok = True
    for c in codes:
        lo, hi = int(c.min()), int(c.max())
        rng = hi - lo + 1
        if rng <= 0 or total * rng > (1 << 62) // max(len(c), 1):
            ok = False
            break
        total *= rng
        combined = (combined * rng + (c - lo)) if combined is not None \
            else (c - lo)
    if ok and combined is not None:
        return _first_appearance(combined)
    mat = np.stack(codes, axis=1)
    uniq, first_idx, inv = np.unique(mat, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(uniq), dtype=np.int64)
    remap[order] = np.arange(len(uniq), dtype=np.int64)
    gids = remap[inv.reshape(-1).astype(np.int64)]
    return GroupIndex(gids, len(uniq), first_idx[order].astype(np.int64))


class WindowIndex:
    """Per-left-row [li, ri] ranges into a sorted right table
    (reference INDEX_TYPE_WINDOW, aggr.c:133-158). Aggregates over a
    MAPGROUP with a WindowIndex reduce each range."""
    __slots__ = ("li", "ri", "valid", "n")

    def __init__(self, li, ri, valid):
        self.li = li
        self.ri = ri
        self.valid = valid
        self.n = len(li)


def mapgroup(col: Obj, index) -> Obj:
    """Lazy grouped column (reference TYPE_MAPGROUP)."""
    return Obj(T.MAPGROUP, (col, index))
