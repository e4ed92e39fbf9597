"""Mesh-mode grouped selects: the route that fans a mid/high-cardinality
group-by out over the device mesh.

When RAYFORCE_MESH is on, a grouped select whose shape the distributed
kernels cover — any single-word code space (< 2^61), EVERY aggregate
(count/sum/avg/min/max/first/last/dev/med) over plain nullable columns
plus derived expressions whose values provably fit the f64 lanes — runs
over the mesh instead of on one device:

- count/sum/avg/min/max/first/last/dev ride the partial-aggregate
  all_to_all exchange of parallel/dist.py:dist_wide_groupby, the
  reference's radix-partition grouping (core/index.c:2556) across
  shards. Each distinct (combiner, column, transform) triple is one f64
  lane with the matching decomposable combiner (AGGR_COLLECT merge,
  core/aggr.c:163-181); nullable columns add exact flag lanes (any-null
  for plain-sum propagation, any-non-null for min/max all-null groups:
  typed-INF min init per aggr.c:1241, typed-NULL max); first/last
  resolve positionally by global row id; dev rides globally-shifted sum
  moments.
- med (not decomposable) rides the raw-row shuffle of dist_med_groupby:
  complete groups per shard + local sorted selection, aligned to the
  partial kernel by first-row ids.

Unsupported shapes fall back to the single-device sort-agg and wide
plans (still correct: their columns are not sharded).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import Obj, table, DevPendingSliced
from . import device as dev
from .exprc import as_tensor, torch_dtype

SUM_OUT = {T.U8: T.I64, T.I16: T.I64, T.I32: T.I32, T.I64: T.I64}

_NUMERIC = (T.U8, T.I16, T.I32, T.I64, T.F64)

I64, F64 = torch.int64, torch.float64


class _DPlan:
    __slots__ = ("mesh", "run_kernel", "run_med", "col_objs",
                 "key_meta", "aggs", "n_rows", "agg_lane", "lane_ops")


def _tdt(rt):
    return torch_dtype(T.DTYPE[rt])


def _nulls(raw, rtype):
    """The null predicate on typed values (int sentinels of
    core/types.py NULL_BY_TYPE, widened before the compare; f64 nulls
    are NaN)."""
    if rtype == T.F64:
        return torch.isnan(raw)
    nv = T.NULL_BY_TYPE.get(rtype)
    if nv is None:
        return torch.zeros(raw.shape, dtype=torch.bool, device=raw.device)
    return raw.to(I64) == int(nv)


def build_plan(src, n_rows, cw, key_cs, key_meta, n_codes, aggs, mesh):
    """Distributed grouped-select plan, or None when the shape is not
    covered (the caller falls back to the single-device engines)."""
    if n_codes > (1 << 61) or n_rows == 0:
        return None
    # one f64 exchange lane per distinct (combiner, column, transform);
    # nullable columns add exact flag lanes instead of sentinel-compare
    # tricks (so +/-inf DATA values stay correct)
    lane_ops: list = []     # combiner per lane
    lane_exprs: list = []   # (value expr, transform) per lane
    lane_of: dict = {}      # (op, col id, transform) -> lane index
    med_exprs: list = []    # value exprs for the median shuffle kernel
    med_of: dict = {}       # col id -> median lane index
    agg_lane: dict = {}     # agg position -> lane-role dict or None
    nullable: dict = {}     # col id -> bool
    for ai, a in enumerate(aggs):
        if a.name == "count":
            agg_lane[ai] = None
            continue
        if a.name not in ("sum", "avg", "min", "max", "first",
                          "last", "dev", "med"):
            return None
        if a.inner.rtype not in _NUMERIC:
            return None
        plain = bool(a.meta.get("plain_col"))
        # plain single-column aggs key lanes by the COLUMN, so `sum v`
        # and `avg v` share one sum lane instead of exchanging it twice
        cid = id(a.inner.cols[0].col) if plain else id(a.inner)
        lo = hi = None
        if plain:
            try:
                col = a.inner.cols[0].col
                if cid not in nullable:
                    nullable[cid] = bool(dev.column_has_null(col))
                lo, hi = dev.column_range(col)
                if a.inner.rtype != T.F64:
                    reach = max(abs(int(lo)), abs(int(hi)))
                    # all lanes are f64: sums need exactness over the
                    # whole column's reach, min/max only per value
                    lim = (1 << 53) // max(n_rows, 1) \
                        if a.name in ("sum", "avg") else (1 << 53)
                    if reach >= lim:
                        return None
                if a.name == "dev" and not (
                        np.isfinite(lo) and np.isfinite(hi)):
                    return None
            except Exception as e:
                if dev.is_fault(e):
                    raise
                return None
        else:
            # derived expressions: dev needs stats for its stabilizing
            # shift (single device); int-typed results need an interval
            # bound (exprc.expr_range) to prove the f64 lanes hold them
            # exactly; f64-typed ones distribute as they are
            if a.name == "dev":
                return None
            if a.inner.rtype != T.F64:
                from . import exprc
                ast = getattr(a.inner, "ast", None)
                tb = getattr(a.inner, "tbl", None)
                r = exprc.expr_range(tb, ast) \
                    if ast is not None and tb is not None else None
                if r is None:
                    return None
                reach = max(abs(r[0]), abs(r[1]))
                lim = (1 << 53) // max(n_rows, 1) \
                    if a.name in ("sum", "avg") else (1 << 53)
                if reach >= lim:
                    return None
            nullable[cid] = True     # null-detect on computed values

        def lane(op, tf):
            lk = (op, cid, tf)
            if lk not in lane_of:
                lane_of[lk] = len(lane_ops)
                lane_ops.append(op)
                lane_exprs.append((a.inner, tf))
            return lane_of[lk]

        nul = nullable[cid]
        if a.name == "sum":
            roles = {"v": lane("sum", "null0" if nul else "raw")}
            if nul and plain:
                # plain sum PROPAGATES nulls (aggr.c ADD accumulators);
                # a DERIVED expression's per-group sum SKIPS them
                # (oracle-pinned): no flag lane
                roles["anynull"] = lane("max", "isnull")
        elif a.name == "avg":
            roles = {"v": lane("sum", "null0" if nul else "raw")}
            if nul:     # avg SKIPS nulls: divide by the non-null count
                roles["nn"] = lane("sum", "notnull")
        elif a.name == "min":
            roles = {"v": lane("min", "mininf" if nul else "raw")}
            if nul:
                roles["anyval"] = lane("max", "notnull")
                # derived min all-null -> typed NULL, not INF
                roles["plain"] = plain
        elif a.name == "max":
            roles = {"v": lane("max", "maxninf" if nul else "raw")}
            if nul:
                roles["anyval"] = lane("max", "notnull")
        elif a.name in ("first", "last"):
            # positional; nulls ride through (int null sentinels are
            # powers of two, exact in f64)
            roles = {"v": lane(a.name, "raw")}
        elif a.name == "med":
            # not decomposable: rides the raw-row shuffle kernel
            if cid not in med_of:
                med_of[cid] = len(med_exprs)
                med_exprs.append((a.inner, "nanify"))
            roles = {"med": med_of[cid]}
        else:           # dev: globally-shifted sum moments (the column
            # midpoint conditions E[x'^2]-E[x']^2 well enough for fmt
            # precision since |x'| <= span/2)
            c = float(lo + (hi - lo) / 2.0)
            roles = {"v": lane("sum", ("shift", c)),
                     "v2": lane("sum", ("shiftsq", c))}
            if nul:     # dev SKIPS nulls
                roles["nn"] = lane("sum", "notnull")
        agg_lane[ai] = roles

    col_objs: list = []
    slot_of: dict = {}

    def assign(ck):
        mapping = []
        for ref in ck.cols:
            key = id(ref.col)
            if key not in slot_of:
                slot_of[key] = len(col_objs)
                col_objs.append(ref.col)
            mapping.append(slot_of[key])
        return mapping

    w_map = assign(cw) if cw is not None else None
    key_maps = [assign(ck) for ck in key_cs]
    lane_maps = [assign(e) for e, _tf in lane_exprs]
    med_maps = [assign(e) for e, _tf in med_exprs]

    from ..parallel import dist
    n_dev = mesh.n
    rows_local = (n_rows + n_dev - 1) // n_dev
    # stage A of dist_wide_groupby sorts the code alone (no row position
    # in the key), so it no longer needs this bound; the gate only keeps
    # the shapes past it on the single-device wide engine, as before
    # stage A's kernels, so that no query changes its route
    code_bits = max(int(n_codes - 1).bit_length(), 1)
    pos_bits = max(int(rows_local - 1).bit_length(), 1)
    if code_bits + pos_bits > 62:
        return None

    plan = _DPlan()
    plan.mesh = mesh
    plan.col_objs = col_objs
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_rows = n_rows
    plan.agg_lane = agg_lane
    plan.lane_ops = tuple(lane_ops)

    def make_builder(exprs, maps):
        """Per-shard builder: codes (i64, -1 = masked or padding)
        followed by one f64 lane per (expr, transform) pair."""
        def builder(me, cols):
            def sub_env(mapping):
                return [cols[i] for i in mapping]

            nl = int(cols[0].shape[0]) if cols else rows_local
            d = cols[0].device if cols else dev.device()
            mask = me * rows_local + torch.arange(nl, device=d) < n_rows
            if cw is not None:
                mask = mask & as_tensor(cw.fn(sub_env(w_map))).to(
                    d, torch.bool)
            codes = None
            for ck, mp, (_nm, lo, rng, _rt, _dom) in zip(
                    key_cs, key_maps, key_meta):
                cc = as_tensor(ck.fn(sub_env(mp))).to(d, I64) - int(lo)
                codes = cc if codes is None else codes * int(rng) + cc
            if codes is None:
                codes = torch.zeros(nl, dtype=I64, device=d)
            codes = torch.where(mask, codes.expand(nl), -1)

            def mk_lane(e, tf, mp):
                raw = as_tensor(e.fn(sub_env(mp))).to(d).expand(nl)
                if tf == "raw":
                    return raw.to(F64)
                nul = _nulls(raw, e.rtype)
                if tf == "isnull":
                    return nul.to(F64)
                if tf == "notnull":
                    return (~nul).to(F64)
                v = raw.to(F64)
                if isinstance(tf, tuple):   # ("shift"|"shiftsq", c)
                    sh = v - tf[1]
                    return torch.where(nul, 0.0,
                                       sh if tf[0] == "shift" else sh * sh)
                fill = {"nanify": math.nan, "null0": 0.0,
                        "mininf": math.inf, "maxninf": -math.inf}[tf]
                return torch.where(nul, fill, v)

            lanes = [mk_lane(e, tf, mp)
                     for (e, tf), mp in zip(exprs, maps)]
            return [codes] + lanes
        return builder

    def shard_inputs(builder, cols):
        """The builder's outputs over this process's shards, as per-shard
        lists (codes first, then each lane)."""
        outs = [builder(me, [c[me] for c in cols]) if me in mesh.local
                else None for me in range(n_dev)]
        return [dist.pick(outs, j) for j in range(len(dist.here(outs)))]

    code_builder = make_builder(lane_exprs, lane_maps)
    # the per-shard ownership bound ceil(n_codes / n) tightens the merge
    # capacity for dense-ish spaces; wide spaces keep the row bound and
    # the doubling retry
    cap = [max(min(2 * rows_local, -(-n_codes // n_dev)), 64)]
    kernels = {}

    def run_kernel(cols):
        ins = shard_inputs(code_builder, cols)
        while True:
            c = cap[0]
            if c not in kernels:
                kernels[c] = dist.dist_wide_groupby(
                    mesh, rows_local, c, plan.lane_ops, n_codes)
            base = kernels[c]
            dist.stats["exchanged_bytes"] += int(base.est())
            dist.stats["kernel_calls"] += 1
            outs = base.inner(*ins)
            ng_, ovf = prof.host("dgroup.counts", lambda: (
                int(outs[0][0]), int(outs[1][0])))
            if ovf == 0:
                return ng_, outs[2:]
            cap[0] = c * 2

    plan.run_kernel = run_kernel

    if med_exprs:
        med_builder = make_builder(med_exprs, med_maps)
        n_med = len(med_exprs)
        mcaps = [max(2 * rows_local // n_dev, 64),
                 max(2 * rows_local // n_dev, 64)]
        med_kernels = {}

        def run_med(cols):
            ins = shard_inputs(med_builder, cols)
            while True:
                key = (mcaps[0], mcaps[1])
                if key not in med_kernels:
                    med_kernels[key] = dist.dist_med_groupby(
                        mesh, rows_local, key[0], key[1], n_med)
                base = med_kernels[key]
                dist.stats["exchanged_bytes"] += int(base.est())
                dist.stats["kernel_calls"] += 1
                out = base.inner(*ins)
                oe, oo = prof.host("dgroup.overflow", lambda: (
                    int(out[1][0]), int(out[2][0])))
                if oe == 0 and oo == 0:
                    return out[3:]          # (codes, fidx, *medians)
                if oe:
                    mcaps[0] *= 2
                if oo:
                    mcaps[1] *= 2

        plan.run_med = run_med
    else:
        plan.run_med = None
    return plan


def run(plan: _DPlan):
    """Execute; returns the result table (device-resident columns) or
    "empty"."""
    cols = [dev.dev_col_sharded(c, plan.mesh) for c in plan.col_objs]
    ng, outs = plan.run_kernel(cols)
    ocode, ocnt = outs[0], outs[1]
    olanes = outs[3:]
    if ng <= 0:
        return "empty"
    omeds = None
    if plan.run_med is not None:
        # the shuffle kernel orders groups by the same global first-row
        # ids, so its lanes align with the partial exchange's positions
        omeds = plan.run_med(cols)[2:]

    out_names: list[int] = []
    out_cols: list[Obj] = []
    muls = []
    m_ = 1
    for _nm, _lo, rng, _rt, _dom in reversed(plan.key_meta):
        muls.append(m_)
        m_ *= rng
    muls.reverse()
    for (nm, lo, rng, rt, dom), mul in zip(plan.key_meta, muls):
        vals = torch.div(ocode, int(mul), rounding_mode="floor") \
            % int(rng) + int(lo)
        out_names.append(nm)
        if dom is not None:
            out_cols.append(Obj(T.ENUM, DevPendingSliced(vals, ng),
                                domain=dom))
        elif rt == T.SYMBOL:
            out_cols.append(Obj(T.SYMBOL, DevPendingSliced(vals, ng)))
        else:
            out_cols.append(Obj(rt, DevPendingSliced(vals.to(_tdt(rt)),
                                                     ng)))

    for ai, a in enumerate(plan.aggs):
        out_names.append(a.sid)
        roles = plan.agg_lane[ai]
        lane = olanes[roles["v"]] if roles is not None \
            and "v" in roles else None
        rt = a.inner.rtype if a.name != "count" else T.I64
        if a.name == "count":
            col = Obj(T.I64, DevPendingSliced(ocnt.to(I64), ng))
        elif a.name == "med":
            col = Obj(T.F64, DevPendingSliced(omeds[roles["med"]], ng))
        elif a.name == "avg":
            e = olanes[roles["nn"]] if "nn" in roles else ocnt.to(F64)
            col = Obj(T.F64, DevPendingSliced(
                torch.where(e == 0, math.nan, lane / e), ng))
        elif a.name == "dev":
            e = olanes[roles["nn"]] if "nn" in roles else ocnt.to(F64)
            safe = torch.where(e == 0, 1.0, e)
            mean = lane / safe
            var = olanes[roles["v2"]] / safe - mean * mean
            v = torch.sqrt(torch.clamp(var, min=0.0))
            col = Obj(T.F64, DevPendingSliced(
                torch.where(e == 0, math.nan, v), ng))
        elif a.name in ("first", "last"):
            # int null sentinels round-trip the f64 lane exactly
            col = Obj(rt, DevPendingSliced(
                lane if rt == T.F64 else lane.to(_tdt(rt)), ng))
        elif a.name in ("min", "max"):
            # all-null groups: plain grouped min keeps the typed INF
            # init (aggr.c:1241), plain grouped max yields typed NULL
            empty = (olanes[roles["anyval"]] == 0) \
                if "anyval" in roles else None
            if rt == T.F64:
                if empty is not None and (
                        a.name == "max" or not roles.get("plain", True)):
                    lane = torch.where(empty, math.nan, lane)
                # plain f64 min: all-null stays +inf (typed INF)
                col = Obj(T.F64, DevPendingSliced(lane, ng))
            else:
                # the sentinel replaces the cast's value: f64 -> int of
                # an infinity is not defined
                li = lane.to(_tdt(rt))
                if empty is not None:
                    sent = np.iinfo(T.DTYPE[rt]).max \
                        if a.name == "min" and roles.get("plain", True) \
                        else T.NULL_BY_TYPE.get(rt, T.NULL_I64)
                    li = torch.where(empty, int(sent), li)
                col = Obj(rt, DevPendingSliced(li, ng))
        elif rt == T.F64:       # f64 sum: plain sums PROPAGATE nulls
            if "anynull" in roles:
                lane = torch.where(olanes[roles["anynull"]] > 0,
                                   math.nan, lane)
            col = Obj(T.F64, DevPendingSliced(lane, ng))
        else:
            ot = SUM_OUT.get(rt, T.I64)
            # exact while |sum| < 2^53 (the f64 exchange lane); columns
            # of larger reach are declined by build_plan
            li = lane.to(_tdt(ot))
            if "anynull" in roles:
                li = torch.where(olanes[roles["anynull"]] > 0,
                                 int(T.NULL_BY_TYPE.get(ot, T.NULL_I64)),
                                 li)
            col = Obj(ot, DevPendingSliced(li, ng))
        out_cols.append(col)
    return table(Obj(T.SYMBOL, np.asarray(out_names, dtype=np.int64)),
                 out_cols)
