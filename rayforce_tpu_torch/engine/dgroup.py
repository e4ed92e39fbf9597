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
plans (still correct: their columns are not sharded). The null rules and
result types are engine/aggs.py's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import profiler as prof
from ..core import types as T
from ..core.obj import DevPendingSliced
from . import aggs as A
from . import device as dev
from .aggs import tdt

_NUMERIC = (T.U8, T.I16, T.I32, T.I64, T.F64)

I64, F64 = torch.int64, torch.float64


class _DPlan:
    __slots__ = ("mesh", "run_kernel", "run_med", "col_objs",
                 "key_meta", "aggs", "n_rows", "agg_lane", "lane_ops")


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
                lo, hi = dev.column_range(a.inner.cols[0].col)
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

        def lane(op, tf):
            lk = (op, cid, tf)
            if lk not in lane_of:
                lane_of[lk] = len(lane_ops)
                lane_ops.append(op)
                lane_exprs.append((a.inner, tf))
            return lane_of[lk]

        nul = A.may_null(a)
        if a.name == "sum":
            roles = {"v": lane("sum", "null0" if nul else "raw")}
            if A.sum_propagates(a, nul):
                roles["anynull"] = lane("max", "isnull")
        elif a.name == "avg":
            roles = {"v": lane("sum", "null0" if nul else "raw")}
            if nul:     # avg SKIPS nulls: divide by the non-null count
                roles["nn"] = lane("sum", "notnull")
        elif a.name == "min":
            roles = {"v": lane("min", "mininf" if nul else "raw")}
            if nul:
                roles["anyval"] = lane("max", "notnull")
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

    slots = A.Slots(cw, key_cs, [e for e, _tf in lane_exprs + med_exprs])

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
    plan.col_objs = slots.cols
    plan.key_meta = key_meta
    plan.aggs = aggs
    plan.n_rows = n_rows
    plan.agg_lane = agg_lane
    plan.lane_ops = tuple(lane_ops)

    def make_builder(exprs):
        """Per-shard builder: codes (i64, -1 = masked or padding)
        followed by one f64 lane per (expr, transform) pair."""
        def builder(me, cols):
            nl = int(cols[0].shape[0]) if cols else rows_local
            d = cols[0].device if cols else dev.device()
            mask = me * rows_local + torch.arange(nl, device=d) < n_rows
            if cw is not None:
                mask = mask & slots.eval(cw, cols).to(d, torch.bool)
            codes = torch.where(mask, A.key_codes(
                slots, cols, key_cs, key_meta, nl, d, I64), -1)

            def mk_lane(e, tf):
                raw = slots.eval(e, cols).to(d).expand(nl)
                if tf == "raw":
                    return raw.to(F64)
                nul = A.null_mask(raw, e.rtype)
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

            return [codes] + [mk_lane(e, tf) for e, tf in exprs]
        return builder

    def shard_inputs(builder, cols):
        """The builder's outputs over this process's shards, as per-shard
        lists (codes first, then each lane)."""
        outs = [builder(me, [c[me] for c in cols]) if me in mesh.local
                else None for me in range(n_dev)]
        return [dist.pick(outs, j) for j in range(len(dist.here(outs)))]

    code_builder = make_builder(lane_exprs)
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
        med_builder = make_builder(med_exprs)
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

    out_cols = [A.key_obj(km, DevPendingSliced(v.to(tdt(km[3])), ng))
                for km, v in zip(plan.key_meta,
                                 A.key_values(ocode, plan.key_meta))]
    for ai, a in enumerate(plan.aggs):
        roles = plan.agg_lane[ai]
        lane = olanes[roles["v"]] if roles is not None \
            and "v" in roles else None
        rt = a.inner.rtype
        if a.name == "count":
            v = ocnt.to(I64)
        elif a.name == "med":
            v = omeds[roles["med"]]
        elif a.name in ("avg", "dev"):
            e = olanes[roles["nn"]] if "nn" in roles else ocnt.to(F64)
            v = A.avg(lane, e) if a.name == "avg" else \
                A.stddev(lane, olanes[roles["v2"]], e)
        elif a.name in ("first", "last"):
            # int null sentinels round-trip the f64 lane exactly
            v = lane.to(tdt(rt))
        elif a.name in ("min", "max"):
            empty = (olanes[roles["anyval"]] == 0) \
                if "anyval" in roles else None
            # the sentinel replaces the cast's value: f64 -> int of an
            # infinity is not defined
            v = A.minmax_nulls(lane.to(tdt(rt)), empty, a, rt)
        else:
            # exact while |sum| < 2^53 (the f64 exchange lane); columns
            # of larger reach are declined by build_plan
            v = lane.to(tdt(A.result_type(a)))
            if "anynull" in roles:
                v = A.sum_nulls(v, olanes[roles["anynull"]], rt)
        out_cols.append(A.agg_obj(a, DevPendingSliced(v, ng)))
    return A.result_table(plan.key_meta, plan.aggs, out_cols)
