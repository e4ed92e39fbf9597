"""Device fast path for select: plan dispatch for fused filter + group +
aggregate.

`try_select_device` builds (and caches) a plan for a select and runs
it. This slice carries the grouped selects whose dense code space fits
the sort-agg engine (SMALL_N < codes <= dense_max, or any grouped
select with a `dev` aggregate): engine/sortagg.py. Every other shape
returns None and runs on the host path — the reference's own contract
for an unsupported plan:

- <=512 codes, and selects with no `by` (the small-code pipeline);
- more than dense_max codes (the wide-code engine);
- the multi-device mesh.

Each is a ROADMAP item. Aggregate null semantics are oracle-pinned
(tools/oracle.py against the reference binary): GROUPED sum PROPAGATES
nulls while avg/min/max/med skip them; min/max of an all-null group
yield the typed INF sentinel (min) or the typed null (max); count
counts all rows. Group order is first-appearance (core/index.c
group-id assignment). Plans are cached by a structural fingerprint of
the query AST and the identity of the source table.
"""
from __future__ import annotations

import sys

from ..core import types as T
from ..core import symbols
from ..core.obj import Obj, to_np, enum_domain
from . import device as dev
from . import groupby as G
from .exprc import as_tensor, compile_expr, split_aggregate

_plan_cache: dict = {}

# last device query's phase timings, readable via the (internals)
# builtin — the analogue of the reference's -t timeit span recorder
# (chrono.h:62-81, printed per REPL eval in app/repl.c:76)
last_profile: dict = {}

MINMAX_OK = (T.B8, T.U8, T.I16, T.I32, T.I64, T.DATE, T.TIME,
             T.TIMESTAMP, T.F64)


def _fingerprint(ast: Obj) -> str:
    t = ast.t
    if t == T.LIST:
        return "(" + " ".join(_fingerprint(x) for x in ast.v) + ")"
    if t == T.DICT:
        k, v = ast.v
        return "{" + _fingerprint(k) + ":" + _fingerprint(v) + "}"
    if t in (T.UNARY, T.BINARY, T.VARY):
        return "#" + ast.v.name
    if t == -T.SYMBOL:
        q = "'" if ast.attrs & 1 else ""
        return q + symbols.name_of(int(ast.v))
    if t < 0:
        return f"{t}:{ast.v}"
    if t == T.SYMBOL:
        return "[" + " ".join(symbols.name_of(int(s))
                              for s in to_np(ast)) + "]"
    if T.is_vector(t):
        return f"v{t}:{to_np(ast).tobytes().hex()[:64]}"
    return f"t{t}"


class _Agg:
    __slots__ = ("sid", "name", "inner", "meta")

    def __init__(self, sid, name, inner):
        self.sid = sid
        self.name = name
        self.inner = inner       # Compiled
        self.meta = {}


def _parse_by(by_ast):
    by_pairs = []
    if by_ast is not None:
        if by_ast.t == -T.SYMBOL and not (by_ast.attrs & 1):
            by_pairs = [(int(by_ast.v), by_ast)]
        elif by_ast.t == T.DICT:
            bkeys, bvals = by_ast.v
            if bkeys.t != T.SYMBOL:
                return None
            bids = to_np(bkeys)
            by_pairs = [(int(bids[i]), bvals.v[i])
                        for i in range(len(bids))]
        else:
            return None
    return by_pairs


def _compile_keys(src, by_pairs):
    """Compile key exprs, returning (key_cs, key_meta, n_codes) where
    n_codes is the full (possibly huge) dense code-space size."""
    key_cs = []
    key_meta = []   # (name, lo, rng, rtype, enum_dom | None)
    n_codes = 1
    for nm, ast in by_pairs:
        dom = None
        ck = compile_expr(src, ast)
        if ck is None or ck.rtype in (T.F64, T.C8):
            return None
        if len(ck.cols) == 1 and ast.t == -T.SYMBOL and \
                ck.cols[0].col.t == T.ENUM:
            # group on raw enum codes; the output column stays ENUM
            # over the same domain (host parity)
            col = ck.cols[0].col
            dom = col.domain
            lo, hi = 0, max(len(enum_domain(col)) - 1, 0)
            slot = ck.cols[0].slot
            ck.fn = (lambda env, s=slot: env[s])
        elif len(ck.cols) == 1 and ast.t == -T.SYMBOL:
            lo, hi = dev.column_range(ck.cols[0].col)
        else:
            arr = as_tensor(ck.fn([dev.dev_col(r.col) for r in ck.cols]))
            lo, hi = int(arr.min()), int(arr.max())
        rng = hi - lo + 1
        if rng <= 0:
            return None
        n_codes *= rng
        key_cs.append(ck)
        key_meta.append((nm, lo, rng, ck.rtype, dom))
    return key_cs, key_meta, n_codes


def _compile_aggs(src, outs):
    aggs = []
    for sid, ast in outs:
        sp = split_aggregate(src, ast)
        if sp is None:
            return None
        name, inner = sp
        if name not in ("count", "sum", "avg", "min", "max",
                        "first", "last", "med", "dev"):
            return None
        if name in ("sum", "avg", "med", "dev") and inner.rtype not \
                in (T.U8, T.I16, T.I32, T.I64, T.F64):
            return None  # host raises err_type; keep that behavior
        if name in ("min", "max") and inner.rtype not in MINMAX_OK:
            return None
        if name in ("first", "last") and (
                len(inner.cols) != 1 or ast.v[1].t != -T.SYMBOL):
            return None  # first/last of derived exprs -> host path
        ag = _Agg(sid, name, inner)
        ag.meta["plain_col"] = (name != "count" and
                                len(inner.cols) == 1 and
                                ast.v[1].t == -T.SYMBOL)
        aggs.append(ag)
    return aggs


def _build_plan(src, outs, where_ast, by_ast):
    n_rows = len(src)
    cw = None
    if where_ast is not None:
        cw = compile_expr(src, where_ast)
        if cw is None or cw.rtype != T.B8:
            return None

    by_pairs = _parse_by(by_ast)
    if by_pairs is None:
        return None
    keys = _compile_keys(src, by_pairs)
    if keys is None:
        return None
    key_cs, key_meta, n_codes = keys
    aggs = _compile_aggs(src, outs)
    if aggs is None:
        return None

    small = n_codes <= G.SMALL_N
    has_dev = any(a.name == "dev" for a in aggs)
    # the mesh branch (dev.mesh() is None until it is ported) and the
    # wide-code engine (> dense_max codes) are not in this slice
    if n_codes > dev._cfg["dense_max"]:
        return None

    if by_pairs and (not small or has_dev):
        # mid-cardinality (or dev-needing) grouped select: the
        # sort+compaction engine (engine/sortagg.py)
        from . import sortagg
        return sortagg.build_plan(src, n_rows, cw, key_cs, key_meta,
                                  n_codes, aggs)
    # <=512 codes and no-by selects: the small-code pipeline is not in
    # this slice
    return None


_warned = [False]


def warn_fallback(e):
    from ..core import log
    log.debug("device path fallback: %s: %s", type(e).__name__,
              str(e)[:200])
    if not _warned[0]:
        _warned[0] = True
        print(f"rayforce-tpu: device select path disabled by error "
              f"({type(e).__name__}: {str(e)[:200]}); using host path",
              file=sys.stderr)


def try_select_device(interp, src: Obj, outs, where_ast, by_ast, lim,
                      empty_to_none=True):
    """empty_to_none=False returns the string "empty" for an
    all-filtered result instead of collapsing it to None — parted
    streaming uses it to tell an EMPTY partition (skip it) from an
    UNSUPPORTED shape (host fallback)."""
    if not dev.available() or not dev.should_use(len(src)):
        return None
    if not outs:
        return None
    # NOTE: the cache entry PINS src. Keys include id(src); a transient
    # table could die and CPython could hand its id to a NEW same-length
    # table, silently serving a stale plan that computes on the OLD
    # captured columns. Holding src in the entry makes id reuse
    # impossible while the entry lives.
    key = (id(src), len(src),
           _fingerprint(where_ast) if where_ast is not None else "",
           _fingerprint(by_ast) if by_ast is not None else "",
           tuple((sid, _fingerprint(ast)) for sid, ast in outs))
    from ..core import profiler as _prof
    ent = _plan_cache.get(key)
    plan = ent[0] if ent is not None else None
    if plan is None:
        plan = _build_plan(src, outs, where_ast, by_ast)
        _prof.tick("device: build plan")
        if plan is None:
            _plan_cache[key] = ("unsupported", src)
            return None
        _plan_cache[key] = (plan, src)
        if len(_plan_cache) > 512:
            # FIFO eviction: long-running servers must not pin tables
            # (and their device columns) forever
            _plan_cache.pop(next(iter(_plan_cache)))
    if plan == "unsupported":
        return None

    from . import sortagg as _sa
    import time as _t
    t0 = _t.perf_counter()
    r = _sa.run(plan)
    last_profile.clear()
    last_profile.update({"engine": "sortagg",
                         "exec_ms": (_t.perf_counter() - t0) * 1e3,
                         "n_codes": plan.n_codes,
                         "exact": plan.exact})
    return (None if empty_to_none else r) if isinstance(r, str) else r
