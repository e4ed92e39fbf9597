"""Deep structural equality used by find/distinct-on-lists/dict lookup
(reference core/cmp.c cmp_obj)."""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np


def obj_equal(a: Obj, b: Obj) -> bool:
    if a is b:
        return True
    ta, tb = a.t, b.t
    if ta == -T.ENUM:
        from .items import ray_value
        a = ray_value(a)
        ta = a.t
    if tb == -T.ENUM:
        from .items import ray_value
        b = ray_value(b)
        tb = b.t
    if ta < 0 and tb < 0:
        sa, sb = -ta, -tb
        if sa == T.NULL or sb == T.NULL:
            return sa == sb
        num = (T.U8, T.I16, T.I32, T.I64, T.F64, T.B8)
        if sa in num and sb in num:
            va, vb = float(a.v), float(b.v)
            if np.isnan(va) or np.isnan(vb):
                return np.isnan(va) and np.isnan(vb)
            return va == vb
        if sa != sb:
            return False
        if sa == T.GUID:
            return bool((np.asarray(a.v) == np.asarray(b.v)).all())
        return int(a.v) == int(b.v)
    if ta < 0 or tb < 0:
        return False
    if ta == T.LIST and tb == T.LIST:
        if len(a.v) != len(b.v):
            return False
        return all(obj_equal(x, y) for x, y in zip(a.v, b.v))
    if ta == T.DICT and tb == T.DICT:
        return obj_equal(a.v[0], b.v[0]) and obj_equal(a.v[1], b.v[1])
    if ta == T.TABLE and tb == T.TABLE:
        if not obj_equal(a.v[0], b.v[0]):
            return False
        return all(obj_equal(x, y) for x, y in zip(a.v[1], b.v[1]))
    if ta == T.ENUM or tb == T.ENUM:
        from .items import ray_value
        if ta == T.ENUM:
            a = ray_value(a)
        if tb == T.ENUM:
            b = ray_value(b)
        return obj_equal(a, b)
    if ta != tb:
        return False
    if len(a) != len(b):
        return False
    va, vb = to_np(a), to_np(b)
    if ta == T.F64:
        na, nb = np.isnan(va), np.isnan(vb)
        if not (na == nb).all():
            return False
        return bool((va[~na] == vb[~nb]).all())
    return bool((va == vb).all())
