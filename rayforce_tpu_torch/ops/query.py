"""Query layer: select / update / insert / upsert (reference core/query.c,
core/update.c).

`select` consumes a dict whose values are unevaluated ASTs: the reserved
keys from:/where:/by:/take: shape the query; every other entry is an output
column expression evaluated in a query context where the source table's
columns resolve lazily:

  - after `where`, columns are MAPFILTER(col, ids) — kernels consume ids
    without materializing (filter.c filter_map);
  - after `by`, columns are MAPGROUP(col, index) — FN_AGGR builtins receive
    them unmaterialized and dispatch to grouped kernels (aggr.c), non-aggr
    uses materialize per-group value lists (eval.c collect_lazy).

This mirrors the reference select pipeline (query.c:607: fetch -> filters ->
groupings -> mappings -> collect -> build) re-expressed over columnar
numpy/torch kernels instead of a per-thread pool.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core import symbols
from ..core.obj import (Obj, to_np, list_, dict_, table, at_idx, NULL_OBJ,
                        vec_sym)
from ..core.errors import err_type, err_length, err_domain
from ..core.interp import QueryCtx, collect_lazy
from .group import group_single, group_multi, mapgroup, GroupIndex
from .filter import filter_map, filter_collect
from .compose import gather, take_n, unify_list
from .items import ray_where

SYM_FROM = symbols.intern("from")
SYM_WHERE = symbols.intern("where")
SYM_BY = symbols.intern("by")
SYM_TAKE = symbols.intern("take")
RESERVED = {SYM_FROM, SYM_WHERE, SYM_BY, SYM_TAKE}


def _dict_entries(d: Obj):
    keys, vals = d.v
    kt = keys.t
    if kt != T.SYMBOL:
        raise err_type("select needs symbol keys")
    ids = to_np(keys)
    return [(int(ids[i]), vals.v[i]) for i in range(len(ids))]


def _wrap_cols(tbl: Obj, wrapper) -> Obj:
    names, cols = tbl.v
    return table(names, [wrapper(c) for c in cols])


def select_parts(interp, d: Obj):
    """Shared select/update machinery. Returns (src_table, entries, ids,
    gindex, by_names, by_cols, take_limit).

    ids: filter indices (np array) or None; gindex: GroupIndex or None.
    by_cols are the (filtered) group key columns at first-appearance order.
    """
    if d.t != T.DICT:
        raise err_type("select needs a dict")
    entries = _dict_entries(d)
    from_ast = None
    where_ast = None
    by_ast = None
    take_ast = None
    outs = []
    for sid, ast in entries:
        if sid == SYM_FROM:
            from_ast = ast
        elif sid == SYM_WHERE:
            where_ast = ast
        elif sid == SYM_BY:
            by_ast = ast
        elif sid == SYM_TAKE:
            take_ast = ast
        else:
            outs.append((sid, ast))
    if from_ast is None:
        raise err_domain("select needs from:")
    src = collect_lazy(interp.eval(from_ast))
    target_sid = None
    if src.t == -T.SYMBOL:
        # from: 'name -> operate on the named global (update writes back)
        target_sid = int(src.v)
        src = interp.resolve(target_sid)
        if src is None:
            raise err_domain("from: global not found")
    if src.t != T.TABLE:
        raise err_type("from: must be a table")

    # -- where --
    ids = None
    if where_ast is not None:
        interp.qctx.append(QueryCtx(src))
        try:
            mask = collect_lazy(interp.eval(where_ast))
        finally:
            interp.qctx.pop()
        w = ray_where(mask) if mask.t in (T.B8, -T.B8) else mask
        if w.t != T.I64:
            raise err_type("where must yield booleans or indices")
        ids = to_np(w)
        if mask.t == -T.B8:
            # scalar condition: all or nothing
            ids = np.arange(len(src), dtype=np.int64) if int(mask.v) \
                else np.zeros(0, dtype=np.int64)

    # -- by --
    gindex = None
    by_names: list[int] = []
    by_cols: list[Obj] = []
    if by_ast is not None:
        interp.qctx.append(QueryCtx(src))
        try:
            if by_ast.t == -T.SYMBOL and not (by_ast.attrs & 1):
                by_pairs = [(int(by_ast.v), interp.eval(by_ast))]
            elif by_ast.t == T.DICT:
                by_pairs = []
                bkeys, bvals = by_ast.v
                bids = to_np(bkeys)
                for i in range(len(bids)):
                    by_pairs.append((int(bids[i]),
                                     collect_lazy(interp.eval(bvals.v[i]))))
            else:
                v = collect_lazy(interp.eval(by_ast))
                nm = int(by_ast.v) if by_ast.t == -T.SYMBOL \
                    else symbols.intern("x")
                by_pairs = [(nm, v)]
        finally:
            interp.qctx.pop()
        key_cols = []
        for nm, col in by_pairs:
            col = collect_lazy(col)
            if ids is not None and col.t >= 0:
                col = gather(col, ids)
            by_names.append(nm)
            key_cols.append(col)
        gindex = group_multi(key_cols)
        by_cols = [gather(c, gindex.first_ids) for c in key_cols]

    take_limit = None
    if take_ast is not None:
        tv = collect_lazy(interp.eval(take_ast))
        take_limit = int(tv.v)
    return (src, outs, ids, gindex, by_names, by_cols, take_limit,
            target_sid)


def _flat_view(src: Obj) -> Obj:
    """Device view of a parted table: partitions razed once and cached
    on the table (column Obj identity is what keys the device column
    cache, so the flattening must be stable across queries). The host
    streaming path remains the fallback for DBs beyond device memory."""
    _, cols = src.v
    if not any(c.t in T.UNPARTED_OF for c in cols):
        return src
    if isinstance(src.meta, dict) and "flat" in src.meta:
        return src.meta["flat"]
    if len(src) * len(cols) * 8 > (4 << 30):   # ~4 GB guard
        return src
    from .parted import parted_raze
    names, _ = src.v
    flat = table(names, [parted_raze(c) if c.t in T.UNPARTED_OF else c
                         for c in cols])
    if not isinstance(src.meta, dict):
        src.meta = {}
    src.meta["flat"] = flat
    return flat


# partition-streaming device aggregation: None = auto (stream when the
# flat view would exceed the _flat_view guard), True = always stream
# (tests), False = never
STREAM_PARTED = None

# combine op applied to stacked per-partition partials (the reference
# streams partitions through PARTED_MAP and pairwise-merges partials,
# core/aggr.c:183-260; same algebra here)
_COMBINE = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
            "first": "first", "last": "last"}


def _inner_cols_null_free(src, inner) -> bool:
    """True when every column the compiled inner expression reads is
    stats-known null-free in EVERY partition (the gate that makes the
    avg/dev sum+count decomposition exact: grouped sum of a plain
    column propagates nulls while avg/dev skip them)."""
    from ..engine import device as dev
    _names_o, cols = src.v
    by_name = {}
    names = to_np(_names_o)
    for nm, c in zip(names, cols):
        by_name[int(nm)] = c
    for ref in inner.cols:
        pc = by_name.get(symbols.intern(ref.name)
                         if isinstance(ref.name, str) else ref.name)
        if pc is None or pc.t not in T.UNPARTED_OF:
            return False
        for piece in pc.v:
            try:
                if dev.column_has_null(piece):
                    return False
            except Exception as e:
                if dev.is_fault(e):
                    raise
                return False
    return True


def _null_atom(rt_: int):
    """Typed null ATOM for an expression result type, or None when the
    type has no null sentinel (u8/b8 — trivially null-free)."""
    if rt_ == T.F64:
        return Obj(-T.F64, np.float64("nan"))
    nv = T.NULL_BY_TYPE.get(rt_)
    if nv is None:
        return None
    return Obj(-rt_, T.DTYPE[rt_](nv))


def _stream_device_select(interp, src, outs, where_ast, by_ast):
    """Aggregate a parted table partition-at-a-time on the device and
    combine the (small) per-partition partials on the host — the
    streaming path for parted DBs larger than device memory (the
    reference's PARTED_MAP partial-merge, core/aggr.c:183-260).

    Combine-decomposable aggregates (sum/count/min/max/first/last)
    stream directly. avg and dev stream as rewritten sum/count/sumsq
    partials when their input columns are stats-known null-free in
    every partition (avg = sum+count; dev = raw second moment —
    sqrt(Q/C - (S/C)^2), aggr.c map_dev); nullable avg/dev and med
    fall back to the host streaming path."""
    from ..engine.exprc import split_aggregate
    names_o, cols = src.v
    nparts = len(cols[0].v)

    # per-partition sub-tables are CACHED on the parted table: stable
    # object ids let the device plan cache (and jit cache) hit on
    # every later eval instead of rebuilding + recompiling per query
    if not isinstance(src.meta, dict):
        src.meta = {}
    subs = src.meta.setdefault("_subtables", {})

    def sub_table(i):
        t_ = subs.get(i)
        if t_ is None:
            t_ = table(names_o, [c.v[i] for c in cols])
            subs[i] = t_
        return t_

    s0 = sub_table(0)
    combos = []      # ("direct", op) | ("avg",) | ("dev",) per out
    part_outs = []   # rewritten outs driving the per-partition pass
    b = interp.env.builtin
    for k, (sid, ast) in enumerate(outs):
        sp = split_aggregate(s0, ast)
        if sp is None:
            return None
        op = sp[0]
        if op in _COMBINE:
            combos.append(("direct", _COMBINE[op]))
            part_outs.append((sid, ast))
        elif op in ("avg", "dev"):
            inner = ast.v[1]
            # square in f64 (x*1.0 first): narrow int inners (u8,
            # i16...) would wrap their own dtype when squared
            xf = list_([b("*"), inner, Obj(-T.F64, 1.0)])
            nl = _null_atom(sp[1].rtype)
            if nl is None or _inner_cols_null_free(src, sp[1]):
                # null-free (by stats, or a null-less type): plain
                # sum + row count are exact partials
                s_ast = list_([b("sum"), inner])
                c_ast = list_([b("count"), inner])
            else:
                # nullable: avg/dev SKIP nulls while plain-column sum
                # PROPAGATES them, so the partials must skip too —
                # sums of DERIVED expressions skip nulls (x*1.0), and
                # the count lane counts non-null rows via the sentinel
                # test (!= x 0N<t>), the host's elementwise null idiom
                i64s = Obj(-T.SYMBOL, np.int64(symbols.intern("I64")),
                           attrs=1)
                s_ast = list_([b("sum"), xf])
                c_ast = list_([b("sum"), list_(
                    [b("as"), i64s, list_([b("!="), inner, nl])])])
            if op == "avg":
                combos.append(("avg",))
                part_outs.append(
                    (symbols.intern(f"__ps{k}"), s_ast))
                part_outs.append(
                    (symbols.intern(f"__pc{k}"), c_ast))
            else:
                q_ast = list_([b("sum"), list_([b("*"), xf, xf])])
                combos.append(("dev",))
                part_outs.append(
                    (symbols.intern(f"__ps{k}"), s_ast))
                part_outs.append(
                    (symbols.intern(f"__pq{k}"), q_ast))
                part_outs.append(
                    (symbols.intern(f"__pc{k}"), c_ast))
        else:
            return None

    from ..engine.select import try_select_device

    def one(i):
        return try_select_device(interp, sub_table(i), part_outs,
                                 where_ast, by_ast, None,
                                 empty_to_none=False)

    from ..engine.select import _fingerprint
    qkey = (_fingerprint(where_ast) if where_ast is not None else "",
            _fingerprint(by_ast) if by_ast is not None else "",
            tuple((sid, _fingerprint(ast)) for sid, ast in part_outs))
    warm = src.meta.setdefault("_stream_warm", set())
    if nparts > 1 and qkey in warm:
        # warm plans: dispatch partitions concurrently — the device
        # queues transfers/compute across partitions instead of a host
        # sync between each (the reference's pool fans PARTED_MAP
        # chunks, core/pool.c pool_map)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(4, nparts)) as ex:
            partials = list(ex.map(one, range(nparts)))
    else:
        # the cold pass runs serially: it builds each partition's plan
        # and stats (and, on the card, the radix sort's first build
        # and load) once, from one thread; after it the cached
        # sub-tables keep every per-partition plan warm
        partials = [one(i) for i in range(nparts)]
        warm.add(qkey)
    if any(r is None for r in partials):
        # unsupported shape -> be conservative, host path
        return None
    # "empty" = every row of that partition filtered out: it simply
    # contributes nothing (the reference's PARTED_MAP skips empty
    # chunks); all-empty falls to the host for the empty-result
    # semantics
    partials = [r for r in partials if not isinstance(r, str)]
    if not partials:
        return None

    # stack partial tables (host, small) and combine
    pnames = to_np(partials[0].v[0])
    n_keys = len(pnames) - len(part_outs)
    stacked = []
    for ci in range(len(pnames)):
        pieces = [p.v[1][ci] for p in partials]
        base = pieces[0].t
        dom = pieces[0].domain
        arrs = [to_np(p) for p in pieces]
        stacked.append(Obj(base, np.concatenate(arrs), domain=dom))
    if n_keys == 0:
        # no-by: a single global group
        gindex = group_multi([Obj(T.I64, np.zeros(len(stacked[0]),
                                                  dtype=np.int64))])
        key_cols = []
    else:
        key_cols = stacked[:n_keys]
        gindex = group_multi(key_cols)
    from .aggr import grouped_aggregate

    def gsum_f64(col):
        return np.bincount(gindex.gids,
                           weights=to_np(col).astype(np.float64),
                           minlength=len(gindex.first_ids))

    out_cols = [gather(c, gindex.first_ids) for c in key_cols]
    pi = n_keys
    for combo in combos:
        if combo[0] == "direct":
            out_cols.append(grouped_aggregate(combo[1], stacked[pi],
                                              gindex))
            pi += 1
        elif combo[0] == "avg":
            S, C = gsum_f64(stacked[pi]), gsum_f64(stacked[pi + 1])
            with np.errstate(invalid="ignore", divide="ignore"):
                v = S / C
            out_cols.append(Obj(T.F64, np.where(C == 0, T.NULL_F64,
                                                v)))
            pi += 2
        else:   # dev: population std from raw moments (inputs are
            #     null-free by the gate above, so C counts them all)
            S = gsum_f64(stacked[pi])
            Q = gsum_f64(stacked[pi + 1])
            C = gsum_f64(stacked[pi + 2])
            with np.errstate(invalid="ignore", divide="ignore"):
                m = S / C
                v = np.sqrt(np.maximum(Q / C - m * m, 0.0))
            out_cols.append(Obj(T.F64, np.where(C == 0, T.NULL_F64,
                                                v)))
            pi += 3

    out_sids = np.concatenate(
        [pnames[:n_keys],
         np.array([sid for sid, _a in outs], dtype=pnames.dtype)])
    return table(Obj(names_o.t, out_sids), out_cols)


def _try_device_select(interp, d: Obj):
    """Attempt the fused device path (engine/select.py). Any unsupported
    shape falls back to the host interpreter with identical semantics."""
    from ..engine import device as _dev
    try:
        if d.t != T.DICT:
            return None
        entries = _dict_entries(d)
        from_ast = where_ast = by_ast = take_ast = None
        outs = []
        for sid, ast in entries:
            if sid == SYM_FROM:
                from_ast = ast
            elif sid == SYM_WHERE:
                where_ast = ast
            elif sid == SYM_BY:
                by_ast = ast
            elif sid == SYM_TAKE:
                take_ast = ast
            else:
                outs.append((sid, ast))
        if from_ast is None or not outs:
            return None
        src = collect_lazy(interp.eval(from_ast))
        if src.t == -T.SYMBOL:
            src = interp.resolve(int(src.v))
            if src is None:
                return None
        if src.t != T.TABLE:
            return None
        if not _dev.should_use(len(src)):
            return None
        _, _cols0 = src.v
        parted = any(c.t in T.UNPARTED_OF for c in _cols0)
        if parted:
            flat = src if STREAM_PARTED is True else _flat_view(src)
            if flat is src and STREAM_PARTED is not False and \
                    by_ast is not None:
                out = _stream_device_select(interp, src, outs,
                                            where_ast, by_ast)
                if out is not None:
                    if take_ast is not None:
                        tv = collect_lazy(interp.eval(take_ast))
                        out = _apply_take(out, int(tv.v))
                    return out
                return None
            src = flat
            if src is flat and any(c.t in T.UNPARTED_OF
                                   for c in src.v[1]):
                return None   # too big to raze, not streamable
        from ..engine.select import try_select_device
        lim = None
        if take_ast is not None:
            tv = collect_lazy(interp.eval(take_ast))
            lim = int(tv.v)
        out = try_select_device(interp, src, outs, where_ast, by_ast, lim)
        if out is not None and lim is not None:
            out = _apply_take(out, lim)
        return out
    except Exception as e:
        # no card, a CUDA kernel that failed to build, load, allocate
        # or launch, or a CUDA fault: an error, never a quiet host run
        if _dev.is_fault(e):
            raise
        import os
        from ..engine.select import warn_fallback
        warn_fallback(e)
        if os.environ.get("RAYFORCE_DEBUG"):
            import traceback
            traceback.print_exc()
        return None


def _lazy_table(src: Obj, ids, gindex) -> Obj:
    def wrap(c):
        w = c
        if ids is not None:
            w = filter_map(w, Obj(T.I64, ids))
        if gindex is not None:
            w = mapgroup(w, gindex)
        return w
    return _wrap_cols(src, wrap)


def ray_select(interp, arg) -> Obj:
    from ..core import profiler as prof
    d = collect_lazy(interp.eval(arg))
    prof.since_request("select: eval spec")
    fast = _try_device_select(interp, d)
    if fast is not None:
        return fast
    (src, outs, ids, gindex, by_names, by_cols, lim, _tsid) = \
        select_parts(interp, d)

    lazy = _lazy_table(src, ids, gindex)
    out_names: list[int] = []
    out_cols: list[Obj] = []

    if not outs:
        # bare select: materialized (filtered) table
        names, cols = src.v
        for i, sid in enumerate(to_np(names)):
            out_names.append(int(sid))
            c = cols[i]
            if ids is not None:
                c = filter_collect(c, Obj(T.I64, ids))
            if gindex is not None:
                from .aggr import aggr_collect
                c = aggr_collect(c, gindex)
            out_cols.append(c)
    else:
        interp.qctx.append(QueryCtx(lazy))
        try:
            for sid, ast in outs:
                v = interp.eval(ast)
                out_names.append(sid)
                out_cols.append(v)
        finally:
            interp.qctx.pop()

    n_rows = None
    if gindex is not None:
        n_rows = gindex.n
    # normalize output columns
    norm = []
    for c in out_cols:
        c = collect_lazy(c)
        if c.t >= 0 and n_rows is None:
            n_rows = len(c)
        norm.append(c)
    if n_rows is None:
        n_rows = 1
    final = []
    for c in norm:
        if c.t < 0:
            c = take_n(c, n_rows)
        elif len(c) != n_rows:
            raise err_length("select column length mismatch")
        final.append(c)

    all_names = by_names + out_names
    all_cols = by_cols + final
    if not outs:
        all_names = by_names + out_names
        all_cols = by_cols + final
    out = table(Obj(T.SYMBOL, np.asarray(all_names, dtype=np.int64)),
                all_cols)
    if lim is not None:
        out = _apply_take(out, lim)
    return out


def _apply_take(tbl: Obj, lim: int) -> Obj:
    n = len(tbl)
    if lim >= 0:
        idx = np.arange(min(lim, n), dtype=np.int64)
    else:
        idx = np.arange(max(0, n + lim), n, dtype=np.int64)
    names, cols = tbl.v
    return table(names, [gather(c, idx) for c in cols])


def ray_update(interp, arg) -> Obj:
    """update: select-shaped dict applying grouped/filtered column writes
    copy-on-write (update.c:753-1000)."""
    d = collect_lazy(interp.eval(arg))
    (src, outs, ids, gindex, by_names, by_cols, lim, tsid) = \
        select_parts(interp, d)
    names, cols = src.v
    new_cols = list(cols)
    name_ids = to_np(names)
    lazy = _lazy_table(src, ids, gindex)
    interp.qctx.append(QueryCtx(lazy))
    try:
        for sid, ast in outs:
            v = collect_lazy(interp.eval(ast))
            total = len(src)
            # find or add target column
            hit = np.nonzero(name_ids == sid)[0]
            if gindex is not None:
                v = _broadcast_groups(v, gindex, ids, total, new_cols,
                                      hit, name_ids)
            base_idx = ids if ids is not None else None
            if len(hit):
                ci = int(hit[0])
                new_cols[ci] = _scatter(new_cols[ci], base_idx, v, total)
            else:
                col = _scatter_new(base_idx, v, total)
                name_ids = np.append(name_ids, np.int64(sid))
                new_cols.append(col)
    finally:
        interp.qctx.pop()
    out = table(Obj(T.SYMBOL, name_ids.astype(np.int64)), new_cols)
    if tsid is not None:
        interp.globals[tsid] = out
    return out


def _broadcast_groups(v: Obj, gindex: GroupIndex, ids, total, cols, hit,
                      name_ids) -> Obj:
    """Per-group result -> per-row values (group member broadcast)."""
    if v.t < 0:
        return v
    if len(v) == gindex.source_len:
        return v
    if len(v) != gindex.n:
        raise err_length("update group result length mismatch")
    return gather(v, gindex.gids)


def _scatter(col: Obj, ids, v: Obj, total: int) -> Obj:
    if ids is None:
        if v.t < 0:
            return take_n(v, total)
        if len(v) != total:
            raise err_length("update length mismatch")
        return v
    a_obj = col
    from ..core.interp import collect_lazy as cl
    a_obj = cl(a_obj)
    a = to_np(a_obj).copy()
    if v.t < 0:
        vv = to_np(take_n(v, len(ids)))
    else:
        if len(v) != len(ids):
            raise err_length("update length mismatch")
        vv = to_np(v)
    if a.dtype != vv.dtype:
        a = a.astype(np.result_type(a.dtype, vv.dtype))
    a[ids] = vv
    t = a_obj.t
    if a.dtype != T.DTYPE.get(t, a.dtype):
        # column type changed (e.g. ints -> floats)
        t = T.F64 if a.dtype == np.float64 else t
    return Obj(t, a, domain=a_obj.domain)


def _scatter_new(ids, v: Obj, total: int) -> Obj:
    if ids is None:
        if v.t < 0:
            return take_n(v, total)
        if len(v) != total:
            raise err_length("update length mismatch")
        return v
    # new column: nulls elsewhere
    if v.t < 0:
        base = take_n(v, len(ids))
    else:
        base = v
    t = base.t
    nullv = T.NULL_BY_TYPE.get(t)
    if nullv is None:
        raise err_type("cannot create partial column of this type")
    a = np.full(total, nullv, dtype=T.DTYPE[t])
    a[ids] = to_np(base)
    return Obj(t, a)
