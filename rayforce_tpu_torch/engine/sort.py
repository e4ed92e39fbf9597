"""Device table sort (xasc / xdesc) over device-resident columns.

One stable multi-key sort through the psort entry (on the card the
CUDA radix sort) gives the row order as its own permutation; every
output column is a lazy take (DevPending), so nothing is gathered
until a column is read. Key semantics are the host's (ops/sort.py
sort_key): integer and temporal keys compare raw (typed nulls are the
most negative value and sort first, tests/sort.c:50-60), f64 maps NaN to
-inf and -0.0 to 0.0 (they tie, as the host's numpy compare ties them),
symbol and enum keys compare in STRING order through a host-built rank
table (the reference merge-sorts symbols by string,
core/sort.c:119-159). xdesc is the flip of the stable ascending order,
as on the host, so tied rows come out in reverse row order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import profiler as prof
from ..core import symbols
from ..core import types as T
from ..core.obj import enum_domain, table, to_np
from . import device as dev
from . import psort
from .join import _DEV_COL_OK_SORT, lazy_take_col

I64 = torch.int64
_I32_SPAN = 1 << 32

# {"engine": "device-sort"} after a device table sort ("dist-sort" on
# a mesh)
last_profile: dict = {}


def _rank_key(codes, entry_codes, entry_ids, size):
    """Device key = the string rank of each code's symbol, through a
    host-built table of `size` entries: entry_codes[i] is the code of
    the symbol id entry_ids[i]. Codes are clamped into the table; a null
    code maps to -1."""
    names = [symbols.name_of(int(i)) for i in entry_ids]
    order = np.argsort(np.asarray(names), kind="stable")
    rank = np.zeros(size, dtype=np.int64)
    rank[entry_codes[order]] = np.arange(len(order))
    lut = torch.from_numpy(rank).to(codes.device)
    key = lut[codes.clamp(0, size - 1)]
    return torch.where(codes == int(T.NULL_I64), -1, key)


def _sym_rank_key(ids_dev, id_space_np):
    """Device key = the string rank of each symbol id. id_space_np: the
    distinct non-null ids to rank (host); other ids cannot occur."""
    hi = int(id_space_np.max()) if len(id_space_np) else 0
    return _rank_key(ids_dev, id_space_np, id_space_np, hi + 2)


def _int_key(col):
    """An integer or temporal key; an i64 key whose stats range (with a
    slot below it for the null) spans fewer than 2^32 values rides as
    one i32 word, biased so that the order stays the same."""
    a = dev.dev_col(col)
    if a.dtype != I64:
        return a.to(torch.int32)
    lo, hi = dev.column_range(col)
    nul = dev.column_has_null(col)
    if not lo <= hi or hi - lo + int(nul) >= _I32_SPAN:
        return a
    k = (a - lo) + (int(nul) - (1 << 31))
    if nul:
        k = torch.where(a == int(T.NULL_I64), -(1 << 31), k)
    return k.to(torch.int32)


def _key_array(col):
    """The device sort key of one column, or None when unsupported."""
    t = col.t
    if t == T.F64:
        a = dev.dev_col(col)
        return torch.where(torch.isnan(a), float("-inf"), a) + 0.0
    if t == T.SYMBOL:
        ids = np.unique(to_np(col))
        return _sym_rank_key(dev.dev_col(col), ids[ids != T.NULL_I64])
    if t == T.ENUM:
        dom = to_np(enum_domain(col))
        return _rank_key(dev.dev_col(col), np.arange(len(dom)), dom,
                         max(len(dom), 1))
    if t in (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP):
        return _int_key(col)
    return None


def _mesh_order(m, keys, n, desc):
    """The row order by the mesh's overflow-safe sample sort
    (parallel/dist.py dist_sort_auto, the reference's parallel order-by,
    core/order.c:246), each key row-sharded."""
    from ..parallel import dist
    order = dist.dist_sort_auto(m, n, tuple(k.dtype for k in keys))(
        *[dist.shard_rows(m, k)[0] for k in keys])
    return order.flip(0) if desc else order


def table_order_device(key_cols: list, desc: bool):
    """The row order (an i64 device tensor), or None when a key is
    unsupported. With a mesh the sample sort runs first; an error that
    is not a device fault falls back to the one-device sort, as in the
    reference."""
    with prof.span("engine: sort"):
        return _table_order(key_cols, desc)


def _table_order(key_cols, desc):
    keys = []
    for c in key_cols:
        k = _key_array(c)
        if k is None:
            return None
        keys.append(k)
    m = dev.mesh()
    n = int(keys[0].shape[0])
    if m is not None and n > 0:
        try:
            order = _mesh_order(m, keys, n, desc)
        except Exception as e:
            if dev.is_fault(e):
                raise
            from .select import warn_fallback
            warn_fallback(e)
        else:
            last_profile["engine"] = "dist-sort"
            return order
    last_profile["engine"] = "device-sort"
    order = psort.sort_lex(keys, perm=True)[2].to(I64)
    return order.flip(0) if desc else order


def xsort_device(tbl, key_cols: list, desc: bool):
    """The sorted table with lazy device-resident columns, or None."""
    names, cols = tbl.v
    if any(c.t not in _DEV_COL_OK_SORT for c in cols):
        return None
    order = table_order_device(key_cols, desc)
    if order is None:
        return None
    n = len(tbl)
    return table(names, [lazy_take_col(c, order, n) for c in cols])
