"""Boolean logic: and/or (short-circuit special forms), not, like, nil?
(reference core/logic.c, order.c:422, unary.c:147)."""
from __future__ import annotations

import fnmatch

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np, str_of, list_
from ..core.errors import err_type


def _as_bool(o: Obj):
    if o.t == -T.B8:
        return bool(o.v)
    return None


def bool_and(a: Obj, b: Obj) -> Obj:
    if a.t == -T.B8 and b.t == -T.B8:
        return Obj(-T.B8, np.int8(1 if (int(a.v) and int(b.v)) else 0))
    va = _bool_vec(a)
    vb = _bool_vec(b)
    if va.ndim == 0 or vb.ndim == 0:
        r = np.logical_and(va, vb)
    else:
        r = np.logical_and(va, vb)
    if np.ndim(r) == 0:
        return Obj(-T.B8, np.int8(1 if r else 0))
    return Obj(T.B8, r.astype(np.int8))


def bool_or(a: Obj, b: Obj) -> Obj:
    va = _bool_vec(a)
    vb = _bool_vec(b)
    r = np.logical_or(va, vb)
    if np.ndim(r) == 0:
        return Obj(-T.B8, np.int8(1 if r else 0))
    return Obj(T.B8, r.astype(np.int8))


def _bool_vec(o: Obj):
    if o.t == -T.B8:
        return np.bool_(bool(o.v))
    if o.t == T.B8:
        return to_np(o).astype(bool)
    raise err_type("logic op needs booleans")


def ray_and(interp, args: list) -> Obj:
    """Eager elementwise AND — the reference's logic_map evaluates every
    operand (no short-circuit; `if` is the control-flow form),
    logic.c:262."""
    vals = [interp.eval_arg(a, False) for a in args]
    acc = None
    for v in vals:
        acc = v if acc is None else bool_and(acc, v)
    return acc if acc is not None else Obj(-T.B8, np.int8(1))


def ray_or(interp, args: list) -> Obj:
    vals = [interp.eval_arg(a, False) for a in args]
    acc = None
    for v in vals:
        acc = v if acc is None else bool_or(acc, v)
    return acc if acc is not None else Obj(-T.B8, np.int8(0))


def ray_not(o: Obj) -> Obj:
    if o.t == -T.B8:
        return Obj(-T.B8, np.int8(0 if int(o.v) else 1))
    if o.t == T.B8:
        return Obj(T.B8, (1 - to_np(o)).astype(np.int8))
    if o.t == T.LIST:
        return list_([ray_not(e) for e in o.v])
    raise err_type("not needs booleans")


def _glob_match(s: str, p: str) -> bool:
    """The reference's pattern language (string.c str_match): `*` any
    run, `?` one char, `[abc]`/`[^abc]` LITERAL character sets (no
    ranges — `[0-9]` is the set {'0','-','9'}), single-star greedy
    backtracking. fnmatch is NOT equivalent (it expands ranges)."""
    n, m = len(s), len(p)
    si = pi = 0
    bt_p = -1
    bt_s = 0

    def class_at(pj):
        # parse [set] at pj (after '['); returns (chars, invert, next)
        inv = pj < m and p[pj] == "^"
        if inv:
            pj += 1
        chars = set()
        while pj < m and p[pj] != "]":
            chars.add(p[pj])
            pj += 1
        if pj == m:
            return None     # unmatched '['
        return chars, inv, pj + 1

    while si < n:
        if pi >= m:
            return False
        c = p[pi]
        if c == "*":
            bt_p = pi
            while pi < m and p[pi] == "*":
                pi += 1
            if pi == m:
                return True
            bt_s = si
            if p[pi] not in ("[", "?"):
                # fast-forward to the next literal occurrence
                j = s.find(p[pi], si)
                if j < 0:
                    return False
                si = bt_s = j
            continue
        if c == "?":
            si += 1
            pi += 1
            continue
        if c == "[":
            cl = class_at(pi + 1)
            if cl is None:
                return False
            chars, inv, nxt = cl
            ok = (s[si] in chars) != inv
            if ok:
                si += 1
                pi = nxt
                continue
        elif s[si] == c:
            si += 1
            pi += 1
            continue
        if bt_p < 0:
            return False
        pi = bt_p + 1
        bt_s += 1
        si = bt_s
    while pi < m and p[pi] == "*":
        pi += 1
    return pi == m


def ray_like(s: Obj, pat: Obj) -> Obj:
    """Glob match (logic.c:266; pattern language of string.c
    str_match). Symbol operands are a documented superset — the
    reference only accepts strings."""
    p = str_of(pat)
    if s.t == T.C8:
        return Obj(-T.B8, np.int8(1 if _glob_match(str_of(s), p)
                                  else 0))
    if s.t == -T.SYMBOL:
        return Obj(-T.B8, np.int8(1 if _glob_match(str_of(s), p)
                                  else 0))
    if s.t == T.SYMBOL:
        from ..core import symbols
        out = np.asarray(
            [_glob_match(symbols.name_of(int(x)), p)
             for x in to_np(s)], dtype=np.int8)
        return Obj(T.B8, out)
    if s.t == T.ENUM:
        from .items import ray_value
        return ray_like(ray_value(s), pat)
    if s.t == T.LIST:
        return list_([ray_like(e, pat) for e in s.v])
    raise err_type("like needs strings or symbols")


def ray_is_null(o: Obj) -> Obj:
    """nil?: true only for the untyped null (unary.c:147)."""
    return Obj(-T.B8, np.int8(1 if o.t == -T.NULL else 0))
