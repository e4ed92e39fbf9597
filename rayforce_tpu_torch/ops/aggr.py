"""Grouped aggregation over a GroupIndex (reference core/aggr.c).

Per-group disciplines pinned against the oracle / reference Appendix-A
notes: sum/avg/med/dev skip nulls; min/max skip nulls; count counts all
rows; first/last take the group's first/last row value; collect returns the
per-group value vectors.

Host path: stable argsort by group id + reduceat. Device path (engine):
torch segment kernels — same group-id contract.
"""
from __future__ import annotations

import numpy as np

from ..core import types as T
from ..core.obj import Obj, to_np, list_
from ..core.errors import err_type
from .group import GroupIndex, WindowIndex
from .math import SUM_TYPE
from .vops import is_null_np


def _sorted_layout(index: GroupIndex):
    order = np.argsort(index.gids, kind="stable")
    sorted_gids = index.gids[order]
    bounds = np.searchsorted(sorted_gids, np.arange(index.n + 1))
    return order, bounds


def grouped_aggregate(name: str, col: Obj, index) -> Obj:
    if isinstance(index, WindowIndex):
        return window_aggregate(name, col, index)
    if col.t == T.MAPFILTER:
        from .filter import filter_collect
        col = filter_collect(col.v[0], col.v[1])
    if col.t in T.UNPARTED_OF:
        from .parted import parted_raze
        col = parted_raze(col)
    t = col.t
    if t == T.ENUM and name in ("first", "last", "count", "collect", "row"):
        pass
    gids = index.gids
    n = index.n

    if name == "count":
        cnt = np.bincount(gids, minlength=n).astype(np.int64)
        return Obj(T.I64, cnt)

    if name == "first":
        from .compose import gather
        return gather(col, index.first_ids)

    if name == "last":
        from .compose import gather
        last_ids = np.full(n, -1, dtype=np.int64)
        np.maximum.at(last_ids, gids, np.arange(len(gids), dtype=np.int64))
        return gather(col, last_ids)

    a = to_np(col)
    if t == T.ENUM or t == T.SYMBOL:
        if name in ("min", "max", "sum", "avg", "med", "dev"):
            raise err_type(f"{name} on symbols")
    nulls = is_null_np(t, a)

    if name == "sum":
        if t not in SUM_TYPE:
            raise err_type("sum on non-numeric")
        rt = SUM_TYPE[t]
        # GROUPED sum PROPAGATES nulls (ADD-based accumulation,
        # aggr.c:1084-1099 + ops.h ADD*; oracle-pinned: group with any
        # null -> typed null, while whole-vector sum SKIPS)
        anynull = np.zeros(n, dtype=bool)
        if nulls.any():
            np.logical_or.at(anynull, gids, nulls)
        if t == T.F64:
            vals = np.where(nulls, 0.0, a)
            out = np.bincount(gids, weights=vals, minlength=n)
            out = np.where(anynull, T.NULL_F64, out)
            return Obj(T.F64, out)
        vals = np.where(nulls, 0, a).astype(np.int64)
        out = np.zeros(n, dtype=np.int64)
        np.add.at(out, gids, vals)
        nullv = T.NULL_BY_TYPE.get(rt, T.NULL_I64)
        out = np.where(anynull, np.int64(nullv), out)
        return Obj(rt, out.astype(T.DTYPE[rt]))

    if name == "avg":
        if t not in SUM_TYPE:
            raise err_type("avg on non-numeric")
        vals = np.where(nulls, 0.0, a.astype(np.float64))
        s = np.bincount(gids, weights=vals, minlength=n)
        c = np.bincount(gids, weights=(~nulls).astype(np.float64),
                        minlength=n)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = s / c
        out = np.where(c == 0, T.NULL_F64, out)
        return Obj(T.F64, out)

    if name in ("min", "max"):
        # nulls lose to any value; an ALL-null group keeps the init:
        # min -> typed INF (min partials init to INF), max -> typed
        # NULL (aggr.c:1158-1256; oracle-pinned: min [0N..] group =
        # max-int / +inf, max [0N..] group = 0N)
        rt = t
        if t == T.F64:
            init = np.inf if name == "min" else -np.inf
            vals = np.where(nulls, init, a)
            out = np.full(n, init, dtype=np.float64)
            (np.minimum if name == "min" else np.maximum).at(out, gids, vals)
            if name == "max":
                cnt = np.bincount(gids,
                                  weights=(~nulls).astype(np.float64),
                                  minlength=n)
                out = np.where(cnt == 0, T.NULL_F64, out)
            return Obj(T.F64, out)
        info_dt = T.DTYPE[t if t not in (T.DATE, T.TIME, T.TIMESTAMP)
                          else {T.DATE: T.I32, T.TIME: T.I32,
                                T.TIMESTAMP: T.I64}[t]]
        init = np.iinfo(info_dt).max if name == "min" \
            else np.iinfo(info_dt).min
        vals = np.where(nulls, init, a.astype(np.int64))
        out = np.full(n, init, dtype=np.int64)
        (np.minimum if name == "min" else np.maximum).at(out, gids, vals)
        if name == "max":
            cnt = np.bincount(gids,
                              weights=(~nulls).astype(np.float64),
                              minlength=n)
            nullv = T.NULL_BY_TYPE.get(t, T.NULL_I64)
            out = np.where(cnt == 0, np.int64(nullv), out)
        return Obj(rt, out.astype(T.DTYPE[rt]))

    if name in ("med", "dev"):
        if t not in SUM_TYPE:
            raise err_type(f"{name} on non-numeric")
        vals = a.astype(np.float64)
        good = ~nulls
        cnt = np.bincount(gids, weights=good.astype(np.float64),
                          minlength=n).astype(np.int64)
        if name == "dev":
            # exact two-pass moments, vectorized: per-group mean via
            # bincount, then per-group sum of squared deviations
            s = np.bincount(gids, weights=np.where(good, vals, 0.0),
                            minlength=n)
            safe = np.maximum(cnt, 1).astype(np.float64)
            mean = s / safe
            d = np.where(good, vals - mean[gids], 0.0)
            ssd = np.bincount(gids, weights=d * d, minlength=n)
            out = np.sqrt(ssd / safe)
            return Obj(T.F64, np.where(cnt == 0, T.NULL_F64, out))
        # med: one lexsort (gid, nulls-last, value) then select the two
        # middle elements of each group's non-null prefix
        order = np.lexsort((vals, nulls, gids))
        sv = vals[order]
        total = np.bincount(gids, minlength=n)
        starts = np.concatenate([[0], np.cumsum(total)[:-1]])
        lo = starts + np.maximum((cnt - 1) // 2, 0)
        hi = starts + np.maximum(cnt // 2, 0)
        out = 0.5 * (sv[lo] + sv[hi])
        return Obj(T.F64, np.where(cnt == 0, T.NULL_F64, out))

    if name == "collect":
        return aggr_collect(col, index)

    raise err_type(f"unknown aggregate {name}")


def aggr_collect(col: Obj, index) -> Obj:
    """Materialize MAPGROUP: LIST of per-group value vectors
    (aggr.c aggr_collect); over a WindowIndex, per-left-row vectors of
    the window's right values (aggr.c:2233-2245 over
    INDEX_TYPE_WINDOW)."""
    from .compose import gather
    if isinstance(index, WindowIndex):
        li, ri, ok = index.li, index.ri, \
            index.valid & (index.li <= index.ri) & (index.li >= 0)
        out = []
        empty = np.empty(0, dtype=np.int64)
        for i in range(len(li)):
            ids = np.arange(li[i], ri[i] + 1, dtype=np.int64) \
                if ok[i] else empty
            out.append(gather(col, ids))
        return list_(out)
    if isinstance(index, GroupIndex):
        order, bounds = _sorted_layout(index)
        out = []
        for g in range(index.n):
            ids = order[bounds[g]:bounds[g + 1]]
            out.append(gather(col, np.sort(ids)))
        return list_(out)
    raise err_type("bad group index")


def _reduceat_ranges(ufunc, a: np.ndarray, li, ri, empty_val):
    """Reduce a[li[i]:ri[i]+1] per row via interleaved reduceat."""
    n = len(li)
    out = np.full(n, empty_val, dtype=a.dtype if a.dtype != np.bool_
                  else np.int64)
    ok = (li <= ri) & (li >= 0)
    if not ok.any():
        return out, ok
    li_ok = li[ok]
    ri_ok = ri[ok]
    bounds = np.empty(2 * len(li_ok), dtype=np.int64)
    bounds[0::2] = li_ok
    bounds[1::2] = ri_ok + 1
    # reduceat quirk: when bounds[i] == bounds[i+1] the result is
    # a[bounds[i]]; our even slots always have li <= ri so slices are
    # non-empty. End bounds of len(a) must clip to len(a)-1 (reduceat
    # rejects them), which drops the FINAL element from every window
    # ending at the last row — fold a[-1] back into those windows
    # (single-row windows at the last position are already exact via
    # the ind[i] >= ind[i+1] rule).
    bounds_c = np.clip(bounds, 0, len(a) - 1)
    red = ufunc.reduceat(a, bounds_c)[0::2]
    tail = (ri_ok + 1 >= len(a)) & (li_ok < len(a) - 1)
    if tail.any():
        red[tail] = ufunc(red[tail], a[-1])
    out[ok] = red
    return out, ok


def window_aggregate(name: str, col: Obj, w: WindowIndex) -> Obj:
    """Aggregate right-table column over per-left-row windows."""
    from ..core.obj import atom_null
    t = col.t
    a = to_np(col)
    li, ri, valid = w.li, w.ri, w.valid
    ok = valid & (li <= ri) & (li >= 0)
    if name == "count":
        out = np.where(ok, ri - li + 1, 0).astype(np.int64)
        return Obj(T.I64, out)
    if name in ("first", "last"):
        # window first/last SKIP NULLS to the nearest non-null row
        # inside [li, ri] (reference first-non-null-slot semantics,
        # aggr.c:394-438 — oracle-pinned by wjoin_nulls goldens)
        nt = t if t != T.ENUM else T.SYMBOL
        nullsfl = is_null_np(nt, a)
        n_r = len(a)
        iota = np.arange(n_r, dtype=np.int64)
        if name == "first":
            nxt = np.where(nullsfl, n_r, iota)
            nxt = np.minimum.accumulate(nxt[::-1])[::-1]
            pos = nxt[np.clip(li, 0, max(n_r - 1, 0))]
            okfl = ok & (pos <= ri)
        else:
            prv = np.where(nullsfl, -1, iota)
            prv = np.maximum.accumulate(prv)
            pos = prv[np.clip(ri, 0, max(n_r - 1, 0))]
            okfl = ok & (pos >= li)
        idx = np.where(okfl, pos, 0)
        from .compose import gather
        g = gather(col, idx.astype(np.int64))
        if (~okfl).any():
            ga = to_np(g).copy()
            nullv = T.NULL_BY_TYPE.get(nt, 0)
            ga[~okfl] = nullv
            g = Obj(g.t, ga, domain=g.domain)
        return g
    nulls = is_null_np(t, a)
    if name == "sum":
        if t not in SUM_TYPE:
            raise err_type("sum on non-numeric")
        rt = SUM_TYPE[t]
        vals = np.where(nulls, 0, a).astype(
            np.float64 if t == T.F64 else np.int64)
        csum = np.concatenate([[0], np.cumsum(vals)])
        cnul = np.concatenate([[0], np.cumsum(nulls.astype(np.int64))])
        out = np.where(ok, csum[np.clip(ri, -1, None) + 1]
                       - csum[np.clip(li, 0, None)], 0)
        # window sum PROPAGATES nulls (ADD accumulators; oracle-pinned)
        n_null = cnul[np.clip(ri, -1, None) + 1] \
            - cnul[np.clip(li, 0, None)]
        nullv = T.NULL_BY_TYPE.get(rt, T.NULL_I64)
        out = np.where(ok & (n_null > 0),
                       np.float64(T.NULL_F64) if t == T.F64
                       else np.int64(nullv), out)
        # an EMPTY window sums to typed NULL, not 0 (reference Null
        # macro; oracle-pinned by wjoin_nulls goldens)
        out = np.where(ok, out, np.float64(T.NULL_F64) if t == T.F64
                       else np.int64(nullv))
        return Obj(rt, out.astype(T.DTYPE[rt]))
    if name == "avg":
        vals = np.where(nulls, 0.0, a.astype(np.float64))
        cnts = (~nulls).astype(np.float64)
        csum = np.concatenate([[0.0], np.cumsum(vals)])
        ccnt = np.concatenate([[0.0], np.cumsum(cnts)])
        s = csum[np.clip(ri, -1, None) + 1] - csum[np.clip(li, 0, None)]
        c = ccnt[np.clip(ri, -1, None) + 1] - ccnt[np.clip(li, 0, None)]
        with np.errstate(invalid="ignore", divide="ignore"):
            out = s / c
        out = np.where(ok & (c > 0), out, T.NULL_F64)
        return Obj(T.F64, out)
    if name in ("min", "max"):
        if t == T.F64:
            init = np.inf if name == "min" else -np.inf
            vals = np.where(nulls, init, a)
            red, okm = _reduceat_ranges(
                np.minimum if name == "min" else np.maximum, vals, li, ri,
                init)
            if name == "max":
                # a NON-EMPTY ALL-NULL window is typed NULL for max
                # (reference max init = NULL, null loses to any value,
                # ops.h:180-190 — oracle-probed with i32 TIME); the
                # -inf init is ambiguous against real -inf data, so
                # emptiness comes from the exact non-null count. Min
                # keeps its natural +inf (min init = INF).
                cn = np.concatenate(
                    [[0], np.cumsum((~nulls).astype(np.int64))])
                n_valid = cn[np.clip(ri, -1, None) + 1] \
                    - cn[np.clip(li, 0, None)]
                out = np.where(ok & okm & (n_valid > 0), red,
                               T.NULL_F64)
            else:
                out = np.where(ok & okm, red, T.NULL_F64)
            return Obj(T.F64, out)
        base = {T.DATE: T.I32, T.TIME: T.I32, T.TIMESTAMP: T.I64}.get(t, t)
        info = np.iinfo(T.DTYPE[base])
        init = info.max if name == "min" else info.min
        vals = np.where(nulls, init, a.astype(np.int64))
        red, okm = _reduceat_ranges(
            np.minimum if name == "min" else np.maximum, vals, li, ri,
            init)
        nullv = T.NULL_BY_TYPE.get(t, T.NULL_I64)
        out = np.where(ok & okm, red, np.int64(nullv))
        return Obj(t, out.astype(T.DTYPE[t]))
    if name in ("med", "dev"):
        # vectorized selection / moments over the WINDOW ranges
        # (reference aggr.c:2806 aggr_map_dev_window; med via
        # aggr_collect + per-group selection, aggr.c:2233).
        # Nulls skip; empty (or all-null) windows yield 0Nf.
        if t not in SUM_TYPE:
            raise err_type(f"{name} on non-numeric")
        vals = a.astype(np.float64)
        if name == "dev":
            # shifted cumulative moments, mirroring the device kernel
            # (engine/wjoin.py _k_dev) incl. its cancellation floor so
            # host and device print identically
            good = ~nulls
            vz = np.where(nulls, 0.0, vals)
            cnt_all = max(good.sum(), 1)
            c0 = vz.sum() / cnt_all
            x = np.where(nulls, 0.0, vals - c0)
            z = np.zeros(1, dtype=np.float64)
            cs = np.concatenate([z, np.cumsum(x)])
            cs2 = np.concatenate([z, np.cumsum(x * x)])
            cc = np.concatenate([z, np.cumsum(good.astype(np.float64))])
            ric = np.clip(ri, -1, None) + 1
            lic = np.clip(li, 0, None)
            s = cs[ric] - cs[lic]
            s2 = cs2[ric] - cs2[lic]
            c = cc[ric] - cc[lic]
            safe = np.where(c > 0, c, 1.0)
            mean = s / safe
            var = s2 / safe - mean * mean
            floor = (x * x).sum() * np.float64(2.0 ** -48) / safe
            var = np.where(var <= floor, 0.0, var)
            out = np.where(ok & (c > 0),
                           np.sqrt(np.maximum(var, 0.0)), T.NULL_F64)
            return Obj(T.F64, out)
        # med: chunked window expansion + one lexsort per chunk, then
        # select the two middle non-null elements of each window
        out = np.full(len(li), T.NULL_F64, dtype=np.float64)
        okix = np.flatnonzero(ok)
        if len(okix) == 0:
            return Obj(T.F64, out)
        wlen = (ri[okix] - li[okix] + 1).astype(np.int64)
        csz = np.cumsum(wlen)
        CHUNK = 1 << 22
        cut = np.searchsorted(csz, np.arange(CHUNK, csz[-1], CHUNK))
        pieces = np.split(np.arange(len(okix)), cut)
        for piece in pieces:
            if len(piece) == 0:
                continue
            rows = okix[piece]
            lens = wlen[piece]
            tot = int(lens.sum())
            # expanded right-row ids: for window j, li[j] + (0..len-1)
            wid = np.repeat(np.arange(len(piece), dtype=np.int64), lens)
            offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
            rid = li[rows][wid] + (np.arange(tot, dtype=np.int64)
                                   - offs[wid])
            en = nulls[rid]
            # nulls ride the value key as +inf: they sort to the back
            # of each window, so one 2-key lexsort orders everything
            ev = np.where(en, np.inf, vals[rid])
            order = np.lexsort((ev, wid))
            sv = ev[order]
            cnt = np.bincount(wid, weights=(~en).astype(np.float64),
                              minlength=len(piece)).astype(np.int64)
            lo = offs + np.maximum((cnt - 1) // 2, 0)
            hi = offs + np.maximum(cnt // 2, 0)
            res = 0.5 * (sv[lo] + sv[hi])
            out[rows] = np.where(cnt == 0, T.NULL_F64, res)
        return Obj(T.F64, out)
    if name == "collect":
        return aggr_collect(col, w)
    raise err_type(f"window aggregate {name} nyi")


def aggr_row(col: Obj, index) -> Obj:
    """Per-group ROW-ID vectors (reference compose.c:1166 ray_row /
    aggr.c:3118 aggr_row: AGGR_ITER pushes each row's index $x into
    its group's i64 vector; with a where-filter the pushed ids are the
    ORIGINAL table row ids, filter[$i])."""
    from ..core.obj import list_
    ids = None
    if col.t == T.MAPFILTER:
        f = col.v[1]
        if f.t == T.I64:
            ids = to_np(f)
        col = col.v[0]
    if not isinstance(index, GroupIndex):
        raise err_type("row on non-group index")
    order, bounds = _sorted_layout(index)
    out = []
    for g in range(index.n):
        rows = np.sort(order[bounds[g]:bounds[g + 1]]).astype(np.int64)
        if ids is not None:
            rows = ids[rows]
        out.append(Obj(T.I64, rows))
    return list_(out)
