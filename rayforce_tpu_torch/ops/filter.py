"""Lazy filtered columns (reference core/filter.c MAPFILTER).

A MAPFILTER wraps (source column, i64 index vector); `where` produces the
indices, select wraps every column lazily, and kernels either consume the
indices directly or materialize via filter_collect (gather).
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np


def filter_map(col: Obj, ids: Obj) -> Obj:
    return Obj(T.MAPFILTER, (col, ids))


def filter_collect(col: Obj, ids: Obj) -> Obj:
    from .compose import gather
    return gather(col, to_np(ids))


def filter_len(mf: Obj) -> int:
    return len(mf.v[1])
